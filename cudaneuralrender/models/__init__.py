"""Subpackage of cudaneuralrender."""
