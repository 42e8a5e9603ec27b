"""Roofline terms of a dry-run cell and the report tables (the port of
``repro.roofline``)."""
