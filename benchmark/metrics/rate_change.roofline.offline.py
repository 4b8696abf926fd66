from benchmark.common.rate_roofline import share as read  # noqa: F401
