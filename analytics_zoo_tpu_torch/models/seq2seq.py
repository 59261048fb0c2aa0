"""Seq2seq: an encoder / decoder of stacked LSTMs joined by a bridge (the
chatbot family).

Port of ``analytics_zoo_tpu/models/seq2seq.py``: the parameter tree
(``enc_embed``, ``dec_embed``, ``head`` ``{W, b}``, ``enc_lstm_<l>`` and
``dec_lstm_<l>`` ``{W, U, b}``), the teacher-forced forward over
``[encoder_tokens, decoder_tokens]`` (a list, or a dict with keys ``enc``
/ ``dec``) that returns the decoder's token probabilities, each layer's
final ``(h, c)`` bridged to the same decoder layer, and the greedy
``infer``.  The cells run ``LSTM.scan_with_state``; ``infer`` steps them
one token at a time, taking the input product ``x @ W`` first (the cell's
``_step`` reads the product).  Token lookups follow ``jnp.take``
(``keras/layers/embedding.py`` ``take_rows``).  Takes ``device=``
(default: the card; raises without one) and ``generator`` for the initial
weights.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.keras import initializers
from analytics_zoo_tpu_torch.keras.engine import KerasNet, _place
from analytics_zoo_tpu_torch.keras.layers.embedding import take_rows
from analytics_zoo_tpu_torch.keras.layers.recurrent import LSTM
from analytics_zoo_tpu_torch.keras.layers.self_attention import projection


class Seq2seq(KerasNet):
    def __init__(self, vocab_size: int, embed_dim: int = 64,
                 hidden: int = 128, num_layers: int = 1,
                 decoder_vocab_size: Optional[int] = None, device=None,
                 generator: Optional[torch.Generator] = None, **kw):
        super().__init__(**kw)
        self.vocab_size = vocab_size
        self.decoder_vocab = decoder_vocab_size or vocab_size
        self.embed_dim = embed_dim
        self.hidden = hidden
        self.num_layers = num_layers
        self.enc_embed = nn.Parameter(torch.empty(vocab_size, embed_dim))
        self.dec_embed = nn.Parameter(torch.empty(self.decoder_vocab,
                                                  embed_dim))
        self.head = projection(hidden, self.decoder_vocab)
        self._enc_cells, self._dec_cells = [], []
        for layer in range(num_layers):
            d = embed_dim if layer == 0 else hidden
            for cells, side in ((self._enc_cells, "enc"),
                                (self._dec_cells, "dec")):
                cell = LSTM(hidden, return_sequences=True,
                            name=f"{side}_lstm_{layer}")
                cell.ensure_built((None, None, d))
                self.add_module(cell.name, cell)
                cells.append(cell)
        self.init(generator)
        _place(self, device)

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        initializers.uniform(self.enc_embed, generator)
        initializers.uniform(self.dec_embed, generator)

    def _encode(self, enc_tokens):
        """Encoder pass -> each layer's final (h, c), the bridges."""
        h = take_rows(self.enc_embed, enc_tokens)
        bridges = []
        for cell in self._enc_cells:
            h, hf, cf = cell.scan_with_state(h)
            bridges.append((hf, cf))
        return bridges

    def _decode(self, dec_tokens, bridges):
        """Teacher-forced decoder pass from the bridges -> the token
        probabilities and each layer's final state."""
        d = take_rows(self.dec_embed, dec_tokens)
        states = []
        for cell, (hf, cf) in zip(self._dec_cells, bridges):
            d, h_out, c_out = cell.scan_with_state(d, hf, cf)
            states.append((h_out, c_out))
        return torch.softmax(self.head(d), dim=-1), states

    def forward(self, x, seed: Optional[int] = None):
        if isinstance(x, dict):
            enc_tokens, dec_tokens = x["enc"], x["dec"]
        else:
            enc_tokens, dec_tokens = x
        probs, _ = self._decode(dec_tokens, self._encode(enc_tokens))
        return probs

    def compute_output_shape(self, s):
        return (None, None, self.decoder_vocab)

    @torch.inference_mode()
    def infer(self, enc_tokens: np.ndarray, start_sign: int,
              max_seq_len: int = 30, stop_sign: Optional[int] = None):
        """Greedy decode: the encoder runs once; each step feeds the last
        chosen token through every decoder layer from its carried (h, c).
        Stops after ``max_seq_len`` tokens, or once every row chose
        ``stop_sign``.  Returns (B, steps) int32 token ids."""
        self.eval()
        dev = self.device
        enc = torch.from_numpy(np.ascontiguousarray(
            np.atleast_2d(enc_tokens).astype(np.int32))).to(dev)
        states = self._encode(enc)
        token = torch.full((enc.shape[0],), start_sign, dtype=torch.int32,
                           device=dev)
        out = []
        for _ in range(max_seq_len):
            d = take_rows(self.dec_embed, token)               # (B, E)
            new_states = []
            for cell, carry in zip(self._dec_cells, states):
                d, carry = cell._step(torch.matmul(d, cell.W), carry)
                new_states.append(carry)
            states = new_states
            token = torch.argmax(self.head(d), dim=-1).to(torch.int32)
            out.append(token.cpu().numpy())
            if stop_sign is not None and (out[-1] == stop_sign).all():
                break
        return np.stack(out, axis=1)
