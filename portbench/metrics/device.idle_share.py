"""device.idle_share (%): the share of the traced span of whole fits in
which nothing ran on the card, from torch.profiler's device events."""


def read(run):
    t = run.get("trace")
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
