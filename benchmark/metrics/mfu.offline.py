from benchmark.common.readers import mfu as read  # noqa: F401
