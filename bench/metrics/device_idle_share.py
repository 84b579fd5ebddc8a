"""% of the traced window in which no kernel, copy or fill ran on the
card. Layer: device."""


def read(run):
    tr = run["trace"]
    if not tr or tr["window_us"] <= 0 or tr["busy_us"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_us"] / tr["window_us"])
