"""``generate_mfu``: the logical FLOPs of one generation call (composer
and chunked vocoder, counted by ``harness.flops`` on the plain reference)
over the unprofiled window's time per call and the published peak of the
precision its convolutions run in, in %."""


def read(records: dict):
    needed = ("call_flops", "call_s", "peak_flops")
    if any(records.get(k) is None for k in needed):
        return None
    return (100.0 * records["call_flops"] / records["call_s"]
            / records["peak_flops"])
