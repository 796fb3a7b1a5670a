"""ERNIE encoder family (BASELINE "ERNIE-style" configs; architecture parity
target: PaddleNLP ErnieModel — the reference repo hosts the framework, the
model recipe lives downstream, same arrangement as gpt2.py/llama.py).

ERNIE 1.0–3.0 is a BERT-style bidirectional encoder: word + position +
token-type (+ task-type in 3.0) embeddings, post-LN transformer encoder, a
tanh pooler over [CLS], and task heads (masked-LM with tied decoder,
sequence classification). Built purely from paddle_tpu.nn so it exercises
the user-facing stack end to end; attention runs through
nn.MultiHeadAttention (flash path on TPU), masks are additive [B,1,1,S].
"""
from __future__ import annotations

from .. import ops
from ..nn.layer.layers import Layer
from ..nn.layer.common import Linear, Embedding, Dropout
from ..nn.layer.norm import LayerNorm
from ..nn.layer.transformer import TransformerEncoder, TransformerEncoderLayer
from ..nn import functional as F
from ..nn.initializer import Normal


class ErnieConfig:
    def __init__(self, vocab_size=18000, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 hidden_act="gelu", hidden_dropout_prob=0.1,
                 attention_probs_dropout_prob=0.1,
                 max_position_embeddings=513, type_vocab_size=4,
                 task_type_vocab_size=0, initializer_range=0.02,
                 layer_norm_eps=1e-12, pad_token_id=0):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.hidden_act = hidden_act
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        # ERNIE 3.0 adds a task-type embedding stream; 0 disables (1.0/2.0)
        self.task_type_vocab_size = task_type_vocab_size
        self.initializer_range = initializer_range
        self.layer_norm_eps = layer_norm_eps
        self.pad_token_id = pad_token_id

    @classmethod
    def base(cls, **kw):       # ernie-3.0-base-zh geometry
        kw.setdefault("vocab_size", 40000)
        kw.setdefault("max_position_embeddings", 2048)
        kw.setdefault("task_type_vocab_size", 3)
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):       # test config
        kw.setdefault("vocab_size", 256)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("num_attention_heads", 2)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("max_position_embeddings", 64)
        return cls(**kw)


class ErnieEmbeddings(Layer):
    def __init__(self, cfg: ErnieConfig):
        super().__init__()
        init = Normal(std=cfg.initializer_range)
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size,
                                         padding_idx=cfg.pad_token_id,
                                         weight_attr=init)
        self.position_embeddings = Embedding(cfg.max_position_embeddings,
                                             cfg.hidden_size, weight_attr=init)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size,
                                               cfg.hidden_size, weight_attr=init)
        self.task_type_embeddings = (
            Embedding(cfg.task_type_vocab_size, cfg.hidden_size,
                      weight_attr=init)
            if cfg.task_type_vocab_size else None)
        self.layer_norm = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                task_type_ids=None):
        b, s = input_ids.shape
        if position_ids is None:
            position_ids = ops.arange(s, dtype="int64").unsqueeze(0)
        if token_type_ids is None:
            token_type_ids = ops.zeros([b, s], dtype="int64")
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        if self.task_type_embeddings is not None:
            if task_type_ids is None:
                task_type_ids = ops.zeros([b, s], dtype="int64")
            x = x + self.task_type_embeddings(task_type_ids)
        return self.dropout(self.layer_norm(x))


class ErniePooler(Layer):
    def __init__(self, cfg: ErnieConfig):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size,
                            weight_attr=Normal(std=cfg.initializer_range))

    def forward(self, hidden):
        return ops.tanh(self.dense(hidden[:, 0]))


class ErnieModel(Layer):
    def __init__(self, cfg: ErnieConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = ErnieEmbeddings(cfg)
        layer = TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout_prob, activation=cfg.hidden_act,
            attn_dropout=cfg.attention_probs_dropout_prob,
            normalize_before=False,           # ERNIE/BERT are post-LN
            weight_attr=Normal(std=cfg.initializer_range),
            layer_norm_eps=cfg.layer_norm_eps)
        self.encoder = TransformerEncoder(layer, cfg.num_hidden_layers)
        self.pooler = ErniePooler(cfg)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, task_type_ids=None):
        """attention_mask: [B, S] with 1 = attend, 0 = pad (HF/PaddleNLP
        convention) — converted to an additive [B, 1, 1, S] bias.

        With attention_mask=None the encoder attends everywhere and runs
        mask-free (the TPU flash-attention path). This matches HF BERT
        semantics and DIVERGES from PaddleNLP, which synthesizes a pad mask
        from pad_token_id — a data-dependent host check that would break
        program capture here. Padded batches must pass attention_mask."""
        bias = None
        if attention_mask is not None:
            bias = ((1.0 - attention_mask.astype("float32")) * -1e4)
            bias = bias.unsqueeze(1).unsqueeze(1)        # [B,1,1,S]
        x = self.embeddings(input_ids, token_type_ids, position_ids,
                            task_type_ids)
        seq = self.encoder(x, src_mask=bias)
        return seq, self.pooler(seq)


class ErnieForMaskedLM(Layer):
    """MLM head with the PaddleNLP transform (dense + act + LN) and a tied
    decoder over the word-embedding matrix."""

    def __init__(self, cfg: ErnieConfig):
        super().__init__()
        self.ernie = ErnieModel(cfg)
        self.config = cfg
        init = Normal(std=cfg.initializer_range)
        self.transform = Linear(cfg.hidden_size, cfg.hidden_size,
                                weight_attr=init)
        self.transform_ln = LayerNorm(cfg.hidden_size,
                                      epsilon=cfg.layer_norm_eps)
        from ..core.tensor import Parameter
        import numpy as np
        self.decoder_bias = Parameter(np.zeros((cfg.vocab_size,),
                                               np.float32))

    def forward(self, input_ids, token_type_ids=None, labels=None,
                attention_mask=None, position_ids=None, task_type_ids=None,
                ignore_index=-100):
        seq, _ = self.ernie(input_ids, token_type_ids, position_ids,
                            attention_mask=attention_mask,
                            task_type_ids=task_type_ids)
        act = getattr(F, self.config.hidden_act)
        h = self.transform_ln(act(self.transform(seq)))
        logits = ops.matmul(h, self.ernie.embeddings.word_embeddings.weight,
                            transpose_y=True) + self.decoder_bias
        if labels is None:
            return logits
        loss = F.cross_entropy(
            logits.reshape([-1, self.config.vocab_size]),
            labels.reshape([-1]), ignore_index=ignore_index)
        return logits, loss


class ErnieForSequenceClassification(Layer):
    def __init__(self, cfg: ErnieConfig, num_classes=2, dropout=None):
        super().__init__()
        self.ernie = ErnieModel(cfg)
        self.num_classes = num_classes
        self.dropout = Dropout(dropout if dropout is not None
                               else cfg.hidden_dropout_prob)
        self.classifier = Linear(cfg.hidden_size, num_classes,
                                 weight_attr=Normal(std=cfg.initializer_range))

    def forward(self, input_ids, token_type_ids=None, labels=None,
                attention_mask=None, position_ids=None, task_type_ids=None):
        _, pooled = self.ernie(input_ids, token_type_ids, position_ids,
                               attention_mask=attention_mask,
                               task_type_ids=task_type_ids)
        logits = self.classifier(self.dropout(pooled))
        if labels is None:
            return logits
        return logits, F.cross_entropy(logits, labels.reshape([-1]))
