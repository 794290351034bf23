"""device_idle_pct: the share of the traced slice's wall in which no
kernel, memcpy or memset ran on the device."""


def read(rec):
    if rec["window_s"] <= 0.0 or not rec["device"]:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
