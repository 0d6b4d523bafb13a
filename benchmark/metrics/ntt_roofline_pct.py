"""The least time of the transforms that ran over the NTT kernels' device
time, in %.  The transforms by shape come from the program's launch counter
(a replay adds its transforms); the least time of each limb-transform is
`yardstick.ntt_least_s`, frozen at 4-byte words and the H100's peaks."""
from benchmark import yardstick


def read(run):
    t = run.trace
    if t is None or not t.ntt_by_shape:
        return None
    spent = t.device_s(yardstick.is_ntt)
    if spent <= 0:
        return None
    least = sum(count * batch * limbs * yardstick.ntt_least_s(n)[0]
                for (_, batch, limbs, n), count in t.ntt_by_shape.items())
    return 100 * least / spent
