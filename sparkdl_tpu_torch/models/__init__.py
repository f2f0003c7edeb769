"""The ported model zoo (every Flax-native name of the reference's registry) and the weight bridge."""
