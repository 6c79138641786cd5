"""Entry points of the port that drive the models."""
