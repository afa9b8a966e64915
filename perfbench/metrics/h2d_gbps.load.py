"""Host-to-device copy rate: the bytes of the traced window's HtoD
copies over their device time, GB/s."""


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    ops = [o for o in tr.device
           if o.cat == "gpu_memcpy" and "HtoD" in o.name and o.nbytes > 0]
    secs = tr.seconds(ops)
    if secs <= 0:
        return None
    return sum(o.nbytes for o in ops) / secs / 1e9
