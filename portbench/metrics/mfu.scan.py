"""The whole window's share of the card's fp32 peak: the operations the
window's rollouts need at the operands' nonzeros (``portbench.roofline``)
over the traced window's seconds. It bounds K2's roofline share from
below the window: a later change that takes K2 off the path leaves that
share silent, not this one."""
from portbench.roofline import PEAKS


def read(rec):
    k2 = rec.get("k2")
    if not k2:
        return None
    return 100.0 * k2["ops"] / (PEAKS["fp32_flops"] * rec["window_s"])
