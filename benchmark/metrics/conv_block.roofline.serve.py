from benchmark.common.readers import conv_block_roofline as read  # noqa: F401
