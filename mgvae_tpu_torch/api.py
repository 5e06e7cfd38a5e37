"""Object-style public API, counterpart of ``mgvae_tpu/api.py``.

    model = Model(modality="mig", layernorm=True)          # device="cuda"
    graph = BenchParser().read_bench(path)
    hs, hf = model(graph)
    pairs = model.encode_many(graphs, batch_size=16)       # serving path
    prob = model.pred_prob(hf)                              # [N, 1] in [0, 1]
    loss, metrics = model.recon_loss(hs, graph.edge_index)
    model.save(path); model.load(path)                      # the port's checkpoint format
    model.load("model_last.pth")       # also a JAX package checkpoint or a reference .pth
    model.load_pretrained()            # mgvae_tpu_torch/pretrained/model.pth

On CUDA the struct towers and the level recurrence run the hand-written
kernels (``ops/struct_kernel``, ``ops/level_kernel``); with
``num_rounds > 1`` the level recurrence is plain torch, as in the JAX
package. ``variational=True`` (DG_VAE) draws the posterior noise from a
generator on the model's device seeded ``seed + 17``, once per forward or
``encode_many`` request, so that embeddings differ from call to call and
repeat from the seed. The model runs in parity mode: fp32 with
``matmul_precision="highest"`` (no TF32), set for each call and restored
after it (``ops.precision``); the CLI's trainer defaults to "default", TF32.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .data.batching import collate, collate_fit
from .data.graph import CircuitGraph
from .models import dg_ae
from .models.dg_ae import DGConfig, init_params
from .ops.mlp import mlp_apply
from .ops.precision import matmul_precision
from .train import losses
from .utils.checkpoint import load_weights, save_checkpoint


class Model:
    """Per-modality DG_AE / DG_VAE model. The default modality is XAG, as in
    the reference package's ``deepgate.Model``."""

    def __init__(
        self,
        modality: str = "xag",
        dim_hidden: int = 64,
        dim_feature: int = 6,
        s_rounds: int = 4,
        t_rounds: int = 4,
        layernorm: bool = False,
        variational: bool = False,
        input_quirk: bool = True,
        num_rounds: int = 1,
        seed: int = 0,
        params=None,
        state=None,
        device="cuda",
    ):
        self.cfg = DGConfig(
            modality=modality, dim_hidden=dim_hidden, dim_feature=dim_feature,
            s_rounds=s_rounds, t_rounds=t_rounds, layernorm=layernorm,
            variational=variational, input_quirk=input_quirk, num_rounds=num_rounds,
            matmul_precision="highest",
        )
        self.device = torch.device(device)
        if params is None:
            params, state = init_params(self.cfg, seed=seed, device=self.device)
        self.params, self.state = params, state
        self._gen = (torch.Generator(device=self.device).manual_seed(seed + 17)
                     if variational else None)

    def __call__(self, graph):
        return self.forward(graph)

    @torch.inference_mode()
    def forward(self, graph):
        """graph: CircuitGraph | list[CircuitGraph] | collated host batch.
        Returns (hs, hf) tensors with row i = input node i, cropped to the
        real nodes for a graph or a list. A list goes through
        ``collate_fit``; a batch may be plain, chunked or split."""
        crop = None
        if isinstance(graph, CircuitGraph):
            crop = graph.num_nodes
            batch = collate([graph])
        elif isinstance(graph, (list, tuple)):
            # a large list is chunked, so that each chunk takes the fused route
            batch = collate_fit(list(graph))
            crop = int(batch["n_nodes"])
        else:
            batch = graph
        hs, hf, _ = dg_ae.forward(self.params, batch, self.cfg, gen=self._gen)
        # undo the batcher's renumbering (level-major, per chunk or group)
        inv = torch.as_tensor(batch["node_inv"]).to(hs.device).long()
        hs, hf = hs[inv], hf[inv]
        if crop is not None:
            hs, hf = hs[:crop], hf[:crop]
        return hs, hf

    @torch.inference_mode()
    def encode_many(self, graphs, batch_size: int = 16):
        """Per-graph (hs, hf) numpy pairs in input order, ``batch_size``
        graphs per forward: the serving path."""
        out = [None] * len(graphs)
        for start in range(0, len(graphs), batch_size):
            chunk = graphs[start : start + batch_size]
            batch = collate(chunk)
            hs, hf, _ = dg_ae.forward(self.params, batch, self.cfg, gen=self._gen)
            inv = batch["node_inv"]
            hs = hs.cpu().numpy()[inv]
            hf = hf.cpu().numpy()[inv]
            off = 0
            for i, g in enumerate(chunk):
                n = g.num_nodes
                out[start + i] = (hs[off : off + n], hf[off : off + n])
                off += n
        return out

    @torch.inference_mode()
    def pred_prob(self, hf):
        """Probability readout in eval mode (running BatchNorm statistics, no
        dropout), clipped to [0, 1]: [N, 1]."""
        hf = torch.as_tensor(hf, device=self.device)
        with matmul_precision(self.cfg.matmul_precision):
            out, _ = mlp_apply(self.params["readout_prob"], self.state["readout_prob"], hf,
                               train=False)
        return out[:, 0:1].clamp(0.0, 1.0)

    @torch.inference_mode()
    def recon_loss(self, hs, pos_edge_index, gen: torch.Generator | None = None,
                   neg_edges=None):
        """Recon loss and its count metrics on an explicit positive edge set
        [2, E]. Negatives: ``neg_edges`` (src, dst), or E pairs drawn from
        ``gen`` (default: a CPU generator seeded 0)."""
        hs = torch.as_tensor(hs, device=self.device)
        pos = torch.as_tensor(np.asarray(pos_edge_index), device=self.device).to(torch.int32)
        e = pos.shape[1]
        b = {
            "edge_src": pos[0], "edge_dst": pos[1],
            "edge_valid": torch.ones(e, dtype=torch.bool, device=self.device),
            "n_edges": torch.tensor(e, dtype=torch.int32, device=self.device),
            "n_nodes": torch.tensor(hs.shape[0], dtype=torch.int32, device=self.device),
        }
        if neg_edges is None and gen is None:
            gen = torch.Generator().manual_seed(0)
        with matmul_precision(self.cfg.matmul_precision):
            return losses.recon_loss(self.params, hs, b, gen, neg_edges=neg_edges)

    # ------------------------------------------------------------------
    def save(self, path: str):
        """Write params and BatchNorm state in the port's checkpoint format
        (``utils/checkpoint``; epoch 0, no optimizer state)."""
        save_checkpoint(path, 0, self.params, self.state, None, 0.0)

    def load(self, path: str):
        """Load params and state from a checkpoint of this package (a
        trainer's or ``save``'s), of the JAX package (its flax msgpack), or
        a reference ``.pth`` state dict (``utils/checkpoint``), with the
        tolerant merge of the reference's ``Model.load``: leaves the file
        lacks (DG_VAE's heads in a DG_AE file, say) keep the model's own.
        Other content raises ValueError."""
        self.params, self.state = load_weights(path, self.params, self.state, self.cfg,
                                               self.device)
        return self

    def load_pretrained(self, pretrained_model_path: str = ""):
        """``load`` of ``pretrained_model_path``, by default the package's
        ``pretrained/model.pth`` (``mgvae_tpu/api.py:178-184``). The
        repository ships no weights, so without a file this raises
        FileNotFoundError naming the path."""
        path = pretrained_model_path or os.path.join(os.path.dirname(__file__), "pretrained",
                                                     "model.pth")
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no pretrained weights at {path}")
        return self.load(path)
