"""Data-parallel stream codec over a mesh of torch devices."""
