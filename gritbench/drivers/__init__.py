"""Traffic drivers: one module per ``kind`` of traffic file.

A traffic file ``traffic/<name>.json`` names its ``kind``; ``run.py``
loads ``drivers/<kind>.py`` and drives its ``Driver`` through
``setup``, ``window``, ``traced_extras`` (``--trace 1`` only),
``close`` and ``judge``.
"""
