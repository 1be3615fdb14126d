"""Card ms a decode step spends in the kernels launched inside
``moe_apply`` (the profiled steps; None for a model with no experts)."""

from bench.harness.view import device_ms


def read(v):
    sl = v.slice
    if sl is None or not sl.calls.get("decode_step") or not sl.calls.get("moe_apply"):
        return None
    ms = device_ms(sl, "moe_apply@decode_step")
    return ms / sl.calls["decode_step"] if ms > 0 else None
