"""K2's share of its roofline over the traced window: the least time the
card could take for the window's rollouts (``portbench.roofline``) over
K2's device time in the profiler's trace. Nothing where the trace holds
no K2 time."""


def read(rec):
    tr, k2 = rec.get("trace"), rec.get("k2")
    if not tr or not k2 or tr["path_s"] <= 0.0:
        return None
    return 100.0 * k2["bound_s"] / tr["path_s"]
