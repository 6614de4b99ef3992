"""The anomaly-detection MLP family, in PyTorch."""
