"""Card ms a training step spends in the kernels launched inside
``optim.apply_updates`` (AdamW; profiled steps)."""

from bench.harness.view import device_ms


def read(v):
    sl = v.slice
    if sl is None or not sl.calls.get("apply_updates"):
        return None
    ms = device_ms(sl, "apply_updates")
    return ms / sl.calls["apply_updates"] if ms > 0 else None
