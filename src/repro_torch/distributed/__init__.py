"""Fleet carry migration (``sharding``), session liveness
(``fault_tolerance``, with the checkpoint/restart loop) and int8 quantization with error feedback
(``compression``). Sharding over a device mesh is not ported yet."""
