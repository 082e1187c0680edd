"""``device_idle.generate``: 1 - (the union of the device's activity) /
(the wall time) of the traced sub-window of generation calls, in %.
(Held against the unprofiled call instead, the union read above it: the
profiler lengthens the device's own activity.)"""


def read(records: dict):
    union, wall = records.get("trace_union_s"), records.get("trace_wall_s")
    if not union or not wall:
        return None
    return 100.0 * (1.0 - union / wall)
