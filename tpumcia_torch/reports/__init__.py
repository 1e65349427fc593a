"""Part of tpumcia_torch; see the package docstring."""
