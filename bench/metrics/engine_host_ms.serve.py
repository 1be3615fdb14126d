"""Host ms an engine step spends in ``Engine.step`` outside the model's two
calls (``Model.prefill``, ``Model.decode_step``) and the sampler
(``sample_rows``, where the host waits for the step's logits): admission,
paged bookkeeping and callbacks.  Over the window, per step."""


def read(v):
    n = v.calls.get("engine_step", 0)
    if not n:
        return None
    h = v.host_s
    own = h["engine_step"] - sum(h.get(k, 0.0) for k in ("prefill", "decode_step", "sample"))
    return 1e3 * own / n
