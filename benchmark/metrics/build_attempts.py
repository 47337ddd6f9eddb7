"""build_attempts: the placement attempts of the run's last
`hashdb.build_table` (the program's counter `build_table.attempts`):
1 where the first Feistel seed placed every key; each retry (another
seed, a larger stash, a table twice the size) is a further insert pass
over every key."""

import _spans


def read(run):
    got = _spans.program()
    if got is None:
        return None
    return got[1]["counters"].get("build_table.attempts")
