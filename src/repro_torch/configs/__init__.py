"""Model configurations the port supports: the anomaly-mlp family and
the dense, moe, vlm, ssm, hybrid and audio language models."""
