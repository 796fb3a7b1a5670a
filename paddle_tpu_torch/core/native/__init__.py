"""Native helpers compiled with ``g++`` at first use (:mod:`.build`): the
TCPStore daemon, ``store.cc``, and the DataLoader's gather engine,
``dataloader.cc`` (a byte copy of the reference's)."""
