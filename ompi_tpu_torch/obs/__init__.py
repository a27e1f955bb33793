"""Observability planes of the port.

Only the integrity (silent-data-corruption) plane is ported so far
(``obs/integrity.py``); the reference's event ring, trace and health
planes are listed in ROADMAP.md as still to port.
"""
