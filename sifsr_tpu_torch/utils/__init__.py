"""Counting helpers of the port (``utils.flops``)."""
