"""The benchmark's traffic: a frozen copy of the scene generator and the
one general generator that reads a cell's traffic parameters."""
