"""See the package docstring of :mod:`phybench`."""
