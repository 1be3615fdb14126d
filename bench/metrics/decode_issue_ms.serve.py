"""Host ms a call of ``Model.decode_step`` takes to return: the time to
issue a decode step's operations (nothing waits for the card inside it).
Over the window, per call."""


def read(v):
    n = v.calls.get("decode_step", 0)
    return 1e3 * v.host_s["decode_step"] / n if n else None
