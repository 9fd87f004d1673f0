"""Sharding specs for the multi-device layer: the rules that name a
``PartitionSpec`` for every parameter, input and cache leaf (``rules``), and
the logical activation constraints (``ctx``)."""
