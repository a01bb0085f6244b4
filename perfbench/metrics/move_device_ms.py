"""move_device_ms (ms): the device's busy time (the union of its
operations' intervals) per AI move over the device stretch: the mix's
``device_units`` moves from positions that are the same for every seed,
traced on the device alone after the window.
"""


def read(run):
    d = run.device
    moves = d and d["totals"].get("moves")
    if not moves or not d["busy_s"]:
        return None
    return 1e3 * d["busy_s"] / moves
