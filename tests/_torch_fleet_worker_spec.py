"""Engine factories for the port's fleet worker subprocess
(``python -m paddle_tpu_torch.inference.frontend.worker --engine-spec
tests/_torch_fleet_worker_spec.py:make_engine``).

A plain module, loaded by path, that imports only the port: the worker it
runs in must never load JAX or the JAX package."""
import sys

FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")
CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=176,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=128)


def forbidden_modules():
    """Modules of JAX or the JAX package loaded in this process."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def make_model():
    """The tiny Llama of the fleet tests, seeded in torch, on the CPU."""
    import torch

    from paddle_tpu_torch.models.llama_module import LlamaConfig, LlamaForCausalLM
    return LlamaForCausalLM(LlamaConfig(**CFG), device="cpu",
                            generator=torch.Generator().manual_seed(0))


def make_engine():
    """A CPU engine whose ``health`` also reports the forbidden modules
    loaded in the worker (read over RPC by the test)."""
    from paddle_tpu_torch.inference.serving import LLMEngine
    eng = LLMEngine(make_model(), device="cpu", max_batch=3, max_len=64,
                    page_size=8, prefix_cache=True)
    health = eng.health

    def health_with_modules():
        h = health()
        h["forbidden_modules"] = forbidden_modules()
        return h

    eng.health = health_with_modules
    return eng


def exit_if_jax_loaded():
    """Called by the worker entry in place of a factory: exits 0 when the
    worker module, everything it imports and the port's engine left JAX
    and the JAX package unloaded, else 1 naming them."""
    import paddle_tpu_torch.inference.serving  # noqa: F401
    bad = forbidden_modules()
    print("forbidden modules:", bad, flush=True)
    raise SystemExit(1 if bad else 0)
