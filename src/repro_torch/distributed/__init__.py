"""Fleet carry migration (``sharding``). Sharding over a device mesh is
not ported yet."""
