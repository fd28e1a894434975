"""Fleet carry migration (``sharding``) and session liveness
(``fault_tolerance``). Sharding over a device mesh is not ported yet."""
