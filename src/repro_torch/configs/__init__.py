"""Model configurations the port supports (the anomaly-mlp family)."""
