"""Roofline of the port's steps on the H100 (port of ``repro.roofline``):
``analysis`` holds the arithmetic and the card's constants, ``measured``
counts a cell's FLOPs and bytes on the ``meta`` device, ``run`` sweeps the
cells."""
