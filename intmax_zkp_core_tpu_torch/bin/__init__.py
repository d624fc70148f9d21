"""Command-line loops of the reference's binaries (``src/bin/``), as entry points of the port."""
