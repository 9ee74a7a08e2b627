"""msm_roofline: the share, in %, of its roofline that the MSMs of the
profiled proofs reach: their least time on one H100 (``roofline.py``: the
larger of the bytes and the IMAD bound, from the scalars each MSM received)
over the device time of everything launched inside the MSM spans (kernels,
copies and sets, merged), from the profiler's trace."""


def read(run):
    t = run["trace"]
    if not t or t["msm_least_s"] <= 0 or t["msm_device_s"] <= 0:
        return None
    return 100.0 * t["msm_least_s"] / t["msm_device_s"]
