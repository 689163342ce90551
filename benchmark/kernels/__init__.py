"""Kernel counts: one module a hand-written kernel, named as the per-layer
metric ``<module>_roofline`` names it. Each gives ``PATTERNS`` (regular
expressions over the device trace's kernel names) and ``work(launch)`` ->
(operations, bytes) of one launch described by the family's ``launches``:
the work these inputs need, from their shapes (valid keys only, each input
byte read once, each output byte written once), whatever the kernel does.
``peaks`` holds the card's published peaks."""
