"""``step_mfu``: the stage-2 step's logical FLOPs (counted by
``harness.flops`` on the plain reference) over the unprofiled window's
time per step and the published peak of the precision the step's
convolutions run in, in %."""


def read(records: dict):
    needed = ("step_flops", "step_s", "peak_flops")
    if any(records.get(k) is None for k in needed):
        return None
    return (100.0 * records["step_flops"] / records["step_s"]
            / records["peak_flops"])
