"""QPs certified solved in the window over the window's seconds."""


def read(rec):
    return rec["counts"]["solved"] / rec["window_s"]
