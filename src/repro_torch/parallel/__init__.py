"""The port's parallelism: logical-axis sharding (``sharding``), the
pipeline primitive (``pipeline``) and gradient compression
(``compression``)."""
