"""Runtime and database configuration.

Counterpart of `cuclark_tpu/config.py`, carried over unchanged.

The reference fixes its knobs at compile time (src/parameters.hh:35-54,
src/parameters_light_hh:35-55: HTSIZE, MAXHITS, RESERVED, key widths).
Here they are plain runtime dataclasses; the kernels take the values
that matter (k, table geometry) as launch arguments.
"""

from __future__ import annotations

import dataclasses

# Reference constant parity (src/parameters.hh, src/dataType.hh):
MAXK = 32           # max k-mer length (src/parameters.hh:41)
MTRGTS = 65535      # max number of targets (src/dataType.hh:44)
OBJECTNAMEMAX = 40  # read-name truncation incl. NUL (src/parameters.hh:51)
NBN = 1             # number of 'N's joining paired mates (src/parameters.hh:53)

# Full/light presets mirror the reference's two build variants
# (cuCLARK vs cuCLARK-l, src/Makefile:26-33) as runtime presets.
DEFAULT_K_FULL = 31
DEFAULT_K_LIGHT = 27
DEFAULT_GAP_LIGHT = 4   # light DB samples every 4th k-mer (src/main.cc:241-249)


@dataclasses.dataclass(frozen=True)
class DBConfig:
    """Database build parameters.

    k:             k-mer length, 2..32.
    gap:           build-time sampling. 1 = full mode, every overlapping
                   k-mer (src/CuCLARK_hh.hh:1100-1163). >1 = light mode:
                   the genome walk emits NON-overlapping k-mer blocks and
                   keeps every gap-th (reference light build resets the
                   rolling k-mer after each emit, src/CuCLARK_hh.hh:
                   710-731; cuCLARK-l uses gap=4).
    min_count:     minimum occurrence count for a target-specific k-mer
                   to be kept (reference -t flag, src/main.cc:117-123).
    slots:         hash bucket width (entries per bucket row).
    target_load:   desired table load factor; bucket count is the next
                   power of two reaching it.
    num_choices:   1 or 2 hash choices per key. Two-choice keeps high
                   load factors overflow-free; one-choice probes half
                   the bytes but needs a low load factor.
    """

    k: int = DEFAULT_K_FULL
    gap: int = 1
    min_count: int = 0
    slots: int = 2
    target_load: float = 0.7
    num_choices: int = 2
    # Table layout: "qs" (default) = quotient-compressed 32 B rows with
    # the second hash choice confined to a SMALL stash section appended
    # below the main rows, so a probe costs ONE random main-table gather
    # plus one gather confined to the small stash; "q4" = both choices
    # over the full table;
    # "s2" = legacy full-key rows governed by slots/num_choices.
    layout: str = "qs"
    # Host-RAM budget for raw k-mer occurrences during a build; larger
    # inputs spill to disk shards partitioned by k-mer range and reduce
    # out-of-core (the answer to the reference's 146 GB in-RAM mother
    # table, README.md:93-94). None = never spill.
    build_ram_mb: int | None = 4096
    # qs only: when the Poisson-sized stash would grow past 2^20 rows
    # (33.6 MB), widen the main table by one bit instead: halving lambda
    # collapses the overflow tail ~9x (3.3% -> 0.37% of n at lambda
    # 1.91 -> 0.95), trading 2x main bytes for a small stash.  Part of
    # the DB build shared with cuclark_tpu, so a table built by either
    # package has the same bytes.  Disable to minimize memory.
    widen_for_warm_stash: bool = True

    def __post_init__(self):
        if not (2 <= self.k <= MAXK):
            raise ValueError(f"k must be in [2, {MAXK}], got {self.k}")
        if self.gap < 1:
            raise ValueError("gap must be >= 1")
        if self.num_choices not in (1, 2):
            raise ValueError("num_choices must be 1 or 2")
        if not (1 <= self.slots <= 255):
            # the native builder tracks bucket occupancy in uint8;
            # slots past 255 would silently wrap it and corrupt
            # placement long before any sane configuration needs it
            raise ValueError("slots must be in [1, 255]")
        if not (0.0 < self.target_load <= 1.0):
            # 0 divides by zero in choose_nb_bits; > 1 can never place
            raise ValueError(
                f"target_load must be in (0, 1], got {self.target_load}")
        if self.layout not in ("qs", "q4", "s2"):
            raise ValueError("layout must be 'qs', 'q4' or 's2'")


@dataclasses.dataclass(frozen=True)
class ClassifyConfig:
    """Online classification parameters.

    batch_reads:    reads per device batch (padded to this size).
                    Large batches amortize the per-batch host<->device
                    round trip; the pipeline's MAX_BATCH_CELLS cap
                    shrinks long-read batches.
    max_read_len:   padded read length in bases per batch bin; longer
                    reads fall into larger bins (pipeline handles
                    binning) so short-read batches stay dense.
    sample_factor:  query-time bucket subsampling (reference -s flag,
                    src/CuClarkDB.cu:508-524 keeps every s-th nonzero
                    bucket; here: every s-th bucket by index).
    extended:       emit dense per-target hit columns
                    (reference --extended, src/CuCLARK_hh.hh:2014-2031).
    """

    batch_reads: int = 65536
    max_read_len: int = 256
    sample_factor: int = 1
    extended: bool = False
    # DB streaming (the analog of reference swap cycles, src/CuClarkDB.cu:
    # 813-858): when the table exceeds max_table_mb of device memory it is
    # split into bucket-range parts streamed host->device, each part probed
    # against a group of stream_group batches per upload.
    max_table_mb: float | None = None
    stream_group: int = 8

    def __post_init__(self):
        if self.sample_factor < 1:
            raise ValueError("sample_factor must be >= 1")
