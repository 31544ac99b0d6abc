"""Command-line entry points (counterpart of ``repro.launch``)."""
