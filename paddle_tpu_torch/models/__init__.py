"""Model definitions: ``gpt2`` (the reference's GPT-2 on ``nn.Layer``),
``gpt2_module`` (the same GPT-2 as a ``torch.nn.Module``), ``llama``,
``ernie`` (the reference's ERNIE encoder family on ``nn.Layer``), and the
weight bridge from the JAX package's numpy state dicts (``convert``)."""
