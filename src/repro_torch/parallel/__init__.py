"""User-axis partitioning of the sharded deployment."""
