"""The fused 4-bit update's two passes against their byte bound: the least
time their bytes allow at the card's HBM bandwidth (the byte models of each
launch's (L, R, C), every launch in the profiled steps) over the device
time of the two kernels there. A bytes bound: the passes also draw
Threefry noise, which the bound does not price."""

import devtrace
import yardstick


def read(run):
    t = run["trace"]
    launches = t["b1_launches"] if t else []
    kernel_s = devtrace.seconds_of(t["device_s"], yardstick.B1_KERNELS) if t else 0.0
    if not launches or kernel_s <= 0:
        return None
    least = sum(yardstick.B1_BYTES[name](*dims) for name, dims in launches)
    return 100.0 * least / yardstick.HBM_BYTES_PER_S / kernel_s
