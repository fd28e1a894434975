"""The sharding rules, placement over a mesh of devices and fleet carry
sharding (``sharding``), session liveness (``fault_tolerance``, with the
checkpoint/restart loop) and int8 quantization with error feedback and
the int8 collectives over a process group (``compression``)."""
