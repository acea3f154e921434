"""Tensor ops of the port: sampling, DCNv2 and OKS-NMS."""
