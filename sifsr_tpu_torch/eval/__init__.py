"""Evaluation of the port: the on-device image-quality metrics of training."""
