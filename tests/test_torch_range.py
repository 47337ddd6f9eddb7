"""The range query's launch geometry (`kernels.range_geometry`), on the
CPU: the blocks of its launches cover every (read, tile) of a batch
exactly once and stay inside the grid's limits, for every W the range
calls take."""

import numpy as np
import pytest

from cuclark_tpu_torch import kernels

GRID_X_MAX = 2 ** 31 - 1


def covered(R: int, P: int, g: kernels.RangeGeometry) -> np.ndarray:
    """How often the blocks of g's launches cover each (read, tile) of R
    reads of P windows, as int [R, T], the block arithmetic of
    csrc/query.cu's range_query_kernel (and of query_kernel at W 1)."""
    T = -(-P // kernels.TILE)
    G, Tb = g.reads_per_block, g.tiles_per_block
    count = np.zeros(R * T, np.int64)
    u = np.arange(g.windows)
    for base, gy in g.launches:
        bx, by, uu = np.meshgrid(np.arange(g.grid_x), np.arange(gy), u,
                                 indexing="ij")
        live = uu < G * Tb
        r = bx * G + uu // Tb
        t = (base + by) * Tb + uu % Tb
        live &= (r < R) & (t < T)
        count += np.bincount((r * T + t)[live], minlength=R * T)
    return count.reshape(R, T)


@pytest.mark.parametrize("W", [1, 2, 4, 8])
@pytest.mark.parametrize("P", [1, 122, 290, 1024])
@pytest.mark.parametrize("R", [1, 3, 65536])
def test_range_geometry_covers_each_tile_once(R, P, W):
    g = kernels.range_geometry(R, P, W)
    assert g.windows == W
    assert g.reads_per_block * g.tiles_per_block <= W
    assert (covered(R, P, g) == 1).all()
    assert 1 <= g.grid_x <= GRID_X_MAX
    assert all(1 <= gy <= kernels.GRID_Y_MAX for _, gy in g.launches)


@pytest.mark.parametrize("W", [1, 2, 4, 8])
def test_range_geometry_rows_past_grid_limit(W):
    """Rows of more than 65,535 tile groups take several launches, each
    within gridDim.y's limit, and together cover every tile once."""
    T = kernels.GRID_Y_MAX * W + 3 * W + 1
    P = T * kernels.TILE - 17
    g = kernels.range_geometry(2, P, W)
    assert len(g.launches) == 2
    assert [b for b, _ in g.launches] == [0, kernels.GRID_Y_MAX]
    assert all(1 <= gy <= kernels.GRID_Y_MAX for _, gy in g.launches)
    assert (g.reads_per_block, g.tiles_per_block) == (1, W)
    assert (covered(2, P, g) == 1).all()


@pytest.mark.parametrize("P,W,shape", [
    (122, 4, (4, 1)), (122, 8, (8, 1)), (290, 2, (1, 2)), (290, 4, (1, 3)),
    (290, 8, (2, 3)), (1024, 4, (1, 4)), (1024, 8, (1, 8)),
    (1000, 2, (1, 2))])
def test_range_geometry_fills_blocks(P, W, shape):
    """Short reads share a block (W reads of one tile), wider ones fill it
    with whole reads where they fit, else with W tiles of one read."""
    g = kernels.range_geometry(65536, P, W)
    assert (g.reads_per_block, g.tiles_per_block) == shape


@pytest.mark.parametrize("nb_bits,nb_local,W", [
    (17, 1 << 17, 1), (17, (1 << 17) - 1, 1), (17, 1 << 16, 2),
    (17, 1 << 15, 4), (17, 3 << 13, 4), (17, 1 << 14, 4), (17, 1 << 12, 4),
    (25, 1 << 22, 4), (25, 1 << 23, 4), (25, (1 << 24) + 1, 1), (4, 1, 4)])
@pytest.mark.parametrize("layout", ["q4", "s2"])
def test_range_windows(nb_bits, nb_local, W, layout):
    """W is the table's rows over the range's, floored to a power of two
    and capped at RANGE_MAX_WINDOWS (4): 4 for a part of 4 or more, 2 for
    a 2-shard mesh's shard, 1 for the resident range."""
    assert kernels.RANGE_MAX_WINDOWS == 4
    assert kernels.range_windows(nb_bits, nb_local, layout) == W


@pytest.mark.parametrize("nb_local,W", [
    (1 << 17, 1), (1 << 16, 1), (3 << 14, 1), (1 << 15, 4), (1 << 12, 4)])
def test_range_windows_qs(nb_local, W):
    """qs takes the range kernel from W 4 (a quarter of the table or
    less): at 2 its db shards ran no faster in it."""
    assert kernels.range_windows(17, nb_local, "qs") == W
