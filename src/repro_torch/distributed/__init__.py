"""The sharding rules and fleet carry migration (``sharding``), session
liveness (``fault_tolerance``, with the checkpoint/restart loop) and int8
quantization with error feedback (``compression``). Placing tensors over a
multi-device mesh, and the int8 collectives, are not ported yet."""
