"""``logmel_roofline``: the log-mel kernel's least time per launch
(``reference.arith.logmel_least_s``) over its median device time per
launch, from the traced sub-window's activities named ``logmel``, in %."""


def read(records: dict):
    least, took = records.get("logmel_least_s"), records.get("logmel_launch_s")
    if least is None or not took:
        return None
    return 100.0 * least / took
