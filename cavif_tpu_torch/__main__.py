"""`python -m cavif_tpu` — the cavif CLI (see cli.py)."""

from .cli import main

main()
