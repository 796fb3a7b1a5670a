"""Serving: the paged-KV continuous-batching engine (:mod:`.engine`) and
its stable import surface (:mod:`.serving`)."""
