"""The control plane of the serving fleet: the rendezvous key-value store
(:mod:`.store`, ``TCPStore``) and the lease-based membership plane built on
it (:mod:`.membership`).

The collective and auto-parallel stack of ``paddle_tpu.distributed`` is not
ported yet, so this package imports nothing at load time.
"""
