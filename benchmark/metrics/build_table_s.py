"""build_table_s: the set-up's table build, `hashdb.build_table` (the
program's `build_table` span: the key check, each placement attempt,
the verify), in seconds; the run's last build where it made more than
one."""

import _spans


def read(run):
    got = _spans.program()
    if got is None:
        return None
    builds = [s for s in got[1]["spans"] if s.name == "build_table"]
    if not builds:
        return None
    last = max(builds, key=lambda s: s.end_ns)
    return (last.end_ns - last.start_ns) / 1e9
