"""Wall ms from the start of the ``Model.prefill`` call that admits a
prompt to that prompt's first token on the host, the mean over every
prompt admitted in the window."""


def read(v):
    lat = v.prefill_lat
    return 1e3 * sum(lat) / len(lat) if lat else None
