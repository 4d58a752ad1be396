"""100 minus the card's mean utilisation sampled by nvidia-smi every 100 ms
over the traced window (a card-side reading that also sees kernels inside
CUDA-graph conditional bodies)."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["smi"]:
        return None
    return 100.0 - sum(tr["smi"]) / len(tr["smi"])
