"""device_idle_share: the share of the traced window, in %, in which no
operation ran on the device: one less the union of the device's operation
intervals in the profiler's trace over the window's length."""


def read(run: dict):
    if not run.get("window_s"):
        return None
    return 100.0 * (1.0 - run["busy_s"] / run["window_s"])
