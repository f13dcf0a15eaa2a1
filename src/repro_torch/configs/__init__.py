"""Configuration of the port: ``base`` (``ArchConfig`` / ``ShapeConfig``), a
copy of the JAX package's ``configs/base.py``.  ``distributed/elastic``'s
mesh planner reads an ``ArchConfig``; the model configs come with the LM
stack."""
