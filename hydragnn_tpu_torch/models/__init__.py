"""The model chassis, its conv layers and building blocks."""
