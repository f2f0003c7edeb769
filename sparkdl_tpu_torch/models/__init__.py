"""The ported model zoo (Xception so far) and the weight bridge."""
