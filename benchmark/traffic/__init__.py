"""Traffic: ``<name>.json`` files of parameters and the one generator that
reads them (``generator.py``)."""
