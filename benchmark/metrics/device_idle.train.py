"""``device_idle.train``: 1 - (the union of the device's activity) / (the
wall time) of the traced sub-window of training steps, in %. (Held
against the unprofiled step instead, the union read above it: the
profiler lengthens the device's own activity.)"""


def read(records: dict):
    union, wall = records.get("trace_union_s"), records.get("trace_wall_s")
    if not union or not wall:
        return None
    return 100.0 * (1.0 - union / wall)
