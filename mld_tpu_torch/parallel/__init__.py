"""Data parallelism of the port: process groups, batch shards and the
gradient reduction (``ddp``), and the cross-rank metric gather
(``multihost``)."""
