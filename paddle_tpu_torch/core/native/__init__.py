"""Native helpers compiled with ``g++`` at first use (:mod:`.build`): the
TCPStore daemon, ``store.cc``."""
