"""Training state (serving needs only the GP parameters and inducing points)."""
