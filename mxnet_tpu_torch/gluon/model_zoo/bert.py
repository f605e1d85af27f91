"""BERT model family (counterpart of
``mxnet_tpu/gluon/model_zoo/bert.py``: GluonNLP's BERTEncoder/BERTModel
and the bert_12_768_12 / bert_24_1024_16 configurations).

Children and parameters keep the JAX package's structural names
(``encoder.transformer_cells.0.attention.qkv.weight``, ``pooler.bias``).
The one exception: the JAX model lists its position table under two
names, ``position_weight`` and ``position_embed``; the port holds it once,
as ``position_weight`` (``convert.load_jax_params`` drops the equal
alias).

Per encoder cell the feed-forward block runs the matmul-epilogue kernel
(K2) twice: ``ffn_1``'s bias + gelu and ``ffn_2``'s bias (+ dropout in
training); the pooler's bias + tanh is one more launch. Attention is
:func:`ops.contrib.fused_self_attention`: the dense (B, S, H, D) path up
to 1024 tokens, above that one flash-attention launch (K3/K3') per cell
on strided views of the fused QKV, so ``max_length=4096`` serves S 4096
in O(S) attention memory. The model carries no attention mask, as in the
JAX package. Under ``autograd.record()`` the model trains: the 25
Dropout sites and ffn_2's epilogue dropout draw their masks, and the
flash-attention launches save the row log-sum-exp for their backward
kernels.
"""
from __future__ import annotations

from ..._dispatch import amp_cast
from ...base import MXNetError
from ...ops import contrib as _contrib
from ...ops import tensor as _tensor
from .. import nn
from ..block import HybridBlock
from ..nn.basic_layers import _EPILOGUE_ACTS
from ..parameter import DeferredParams

__all__ = ["MultiHeadAttention", "PositionwiseFFN", "TransformerEncoderCell",
           "BERTEncoder", "BERTModel", "bert_12_768_12", "bert_24_1024_16",
           "get_bert_model"]


class MultiHeadAttention(HybridBlock):
    """Self-attention with a fused QKV projection (ref:
    bert.py MultiHeadAttention). Only the single-program path is ported:
    ``seq_parallel`` other than False (ring or Ulysses attention) raises."""

    def __init__(self, units, num_heads, dropout=0.0, use_bias=True,
                 causal=False, attention_block_size=512, seq_parallel=False):
        super().__init__()
        if units % num_heads:
            raise MXNetError(f"units {units} not divisible by num_heads "
                             f"{num_heads}")
        if seq_parallel is not False:
            raise MXNetError(f"seq_parallel={seq_parallel!r} (ring or "
                             "Ulysses attention over a mesh) is not ported "
                             "yet; use seq_parallel=False")
        self._units = units
        self._num_heads = num_heads
        self._causal = causal
        self._block = attention_block_size
        self.qkv = nn.Dense(3 * units, flatten=False, use_bias=use_bias)
        self.proj = nn.Dense(units, flatten=False, use_bias=use_bias)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x):
        # x: (B, S, C); attention straight off the fused QKV
        qkv, = amp_cast("_contrib_fused_self_attention", self.qkv(x))
        out = _contrib.fused_self_attention(
            qkv, heads=self._num_heads, causal=self._causal,
            block_size=self._block)
        out = self.proj(out)
        if self.dropout is not None:
            out = self.dropout(out)
        return out


class PositionwiseFFN(HybridBlock):
    """ref: bert.py PositionwiseFFN — ``ffn_2(act(ffn_1(x)))`` with the
    bias + activation of ``ffn_1`` and the bias + dropout of ``ffn_2``
    each one matmul-epilogue pass. An activation the epilogue does not
    take runs as its own layer after ``ffn_1``."""

    def __init__(self, units, hidden_size, dropout=0.0, activation="gelu"):
        super().__init__()
        fused_act = activation if activation in _EPILOGUE_ACTS else None
        self.ffn_1 = nn.Dense(hidden_size, flatten=False,
                              activation=fused_act)
        if fused_act is not None:
            self.activation = None
        else:
            self.activation = nn.GELU() if activation == "gelu" else \
                nn.Activation(activation)
        self.ffn_2 = nn.Dense(units, flatten=False,
                              epilogue_dropout=dropout)

    def forward(self, x):
        out = self.ffn_1(x)
        if self.activation is not None:
            out = self.activation(out)
        return self.ffn_2(out)


class TransformerEncoderCell(HybridBlock):
    """Post-LayerNorm transformer cell (the BERT arrangement)."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 causal=False, seq_parallel=False):
        super().__init__()
        self.attention = MultiHeadAttention(units, num_heads,
                                            dropout=dropout, causal=causal,
                                            seq_parallel=seq_parallel)
        self.ln1 = nn.LayerNorm(epsilon=1e-12)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout=dropout)
        self.ln2 = nn.LayerNorm(epsilon=1e-12)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x):
        att = self.attention(x)
        if self.dropout is not None:
            att = self.dropout(att)
        x = self.ln1(x + att)
        return self.ln2(x + self.ffn(x))


class BERTEncoder(HybridBlock):
    """Stack of transformer cells (GluonNLP BERTEncoder)."""

    def __init__(self, num_layers, units, hidden_size, num_heads,
                 dropout=0.0, seq_parallel=False):
        super().__init__()
        self._num_layers = num_layers
        self.transformer_cells = nn.HybridSequential()
        for _ in range(num_layers):
            self.transformer_cells.add(TransformerEncoderCell(
                units, hidden_size, num_heads, dropout=dropout,
                seq_parallel=seq_parallel))

    def forward(self, x):
        return self.transformer_cells(x)


class BERTModel(DeferredParams, HybridBlock):
    """GluonNLP BERTModel: embeddings → encoder → pooler, NSP classifier
    and MLM decoder. ``forward(inputs, token_types=None,
    masked_positions=None)`` takes int token ids (B, S) and returns
    ``(seq_out, pooled, nsp_scores[, mlm_scores])`` as the heads are
    enabled (a lone ``seq_out`` when none is); with ``masked_positions``
    (B, M) the decoder scores only those positions of each row."""

    def __init__(self, num_layers=12, units=768, hidden_size=3072,
                 num_heads=12, max_length=512, vocab_size=30522,
                 token_type_vocab_size=2, dropout=0.1, use_pooler=True,
                 use_decoder=True, use_classifier=True, seq_parallel=False):
        super().__init__()
        self._units = units
        self._use_pooler = use_pooler
        self._use_decoder = use_decoder
        self._use_classifier = use_classifier
        self.word_embed = nn.Embedding(vocab_size, units)
        self.token_type_embed = nn.Embedding(token_type_vocab_size, units)
        self._declare("position_weight", (max_length, units))
        self.embed_layer_norm = nn.LayerNorm(epsilon=1e-12)
        self.embed_dropout = nn.Dropout(dropout) if dropout else None
        self.encoder = BERTEncoder(num_layers, units, hidden_size,
                                   num_heads, dropout=dropout,
                                   seq_parallel=seq_parallel)
        if use_pooler:
            self.pooler = nn.Dense(units, activation="tanh", flatten=False)
        if use_decoder:
            self.decoder = nn.HybridSequential()
            self.decoder.add(nn.Dense(units, flatten=False, activation=None))
            self.decoder.add(nn.GELU())
            self.decoder.add(nn.LayerNorm(epsilon=1e-12))
            self.decoder.add(nn.Dense(vocab_size, flatten=False))
        if use_classifier:
            self.classifier = nn.Dense(2)

    def infer_shape(self, x):
        """The position table's shape is fixed at construction."""

    def forward(self, inputs, token_types=None, masked_positions=None):
        x = self.word_embed(inputs)
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        # the (1, max_length, U) table sliced along the sequence axis like
        # x (B, S, U)
        pos = _tensor.slice_like(
            _tensor.expand_dims(self.position_weight, axis=0), x, axes=(1,))
        x = self.embed_layer_norm(x + pos)
        if self.embed_dropout is not None:
            x = self.embed_dropout(x)
        seq_out = self.encoder(x)
        outputs = [seq_out]
        if self._use_pooler:
            pooled = self.pooler(_tensor.squeeze(seq_out[:, 0:1, :], axis=1))
            outputs.append(pooled)
            if self._use_classifier:
                outputs.append(self.classifier(pooled))
        if self._use_decoder:
            if masked_positions is not None:
                # picked[b, m] = seq_out[b, masked_positions[b, m]]
                batch_idx = _tensor.broadcast_like(
                    _contrib.arange_like(masked_positions, axis=0)
                    .reshape(-1, 1), masked_positions)
                idx = _tensor.stack(batch_idx, masked_positions, axis=0)
                outputs.append(self.decoder(_tensor.gather_nd(seq_out, idx)))
            else:
                outputs.append(self.decoder(seq_out))
        return tuple(outputs) if len(outputs) > 1 else outputs[0]


_bert_configs = {
    "bert_12_768_12": dict(num_layers=12, units=768, hidden_size=3072,
                           num_heads=12),
    "bert_24_1024_16": dict(num_layers=24, units=1024, hidden_size=4096,
                            num_heads=16),
}


def get_bert_model(model_name="bert_12_768_12", vocab_size=30522,
                   max_length=512, dropout=0.1, **kwargs):
    """A BERTModel of a named configuration; ``kwargs`` override it."""
    if model_name not in _bert_configs:
        raise MXNetError(f"unknown BERT config {model_name!r}; "
                         f"options: {sorted(_bert_configs)}")
    cfg = dict(_bert_configs[model_name])
    cfg.update(kwargs)
    return BERTModel(vocab_size=vocab_size, max_length=max_length,
                     dropout=dropout, **cfg)


def bert_12_768_12(**kwargs):
    """BERT-base: 12 layers, 768 units, 3072 hidden, 12 heads."""
    return get_bert_model("bert_12_768_12", **kwargs)


def bert_24_1024_16(**kwargs):
    """BERT-large: 24 layers, 1024 units, 4096 hidden, 16 heads."""
    return get_bert_model("bert_24_1024_16", **kwargs)
