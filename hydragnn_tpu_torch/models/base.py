"""The model chassis: shared message-passing encoder + multi-head decoders.

The port's counterpart of ``hydragnn_tpu/models/base.py``: one conv stack
with interleaved masked BatchNorm + ReLU, masked global mean pooling,
then graph heads on a shared dense trunk and node heads of the three
kinds (``mlp``, ``mlp_per_node``, ``conv``). The forward returns one
output per head: [G, dim] for graph heads, [N, dim] for node heads.

The port builds the chassis for every model type of the JAX package
(PNA, GIN, SAGE, MFC, SchNet, CGCNN and GAT) with its weighted
multi-task loss (``model_loss``); PNA, CGCNN and SchNet take edge
features, SchNet can rebuild its radius graph in the forward
(``inforward_radius``), and the conv knobs ``fused_conv`` and
``conv_bf16`` select the conv stacks' paths as in the JAX package.
``freeze_conv`` changes no module: the optimizer masks the encoder
convs' updates (``train/optimizer.py``).

Parameter names mirror the flax tree so ``convert.py`` maps one onto
the other: ``convs.{i}`` = ``conv_{i}``, ``norms.{i}`` =
``MaskedBatchNorm_{i}``, ``graph_shared``, ``heads.{i}`` =
``graph_head_{i}`` / ``node_head_{i}``; a ``conv`` node head's
``heads.{i}.convs.{j}`` and ``heads.{i}.norms.{j}`` are flax's unnamed
convs and the BatchNorms after the encoder's, in creation order.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from hydragnn_tpu_torch.graph import segment as S
from hydragnn_tpu_torch.graph.batch import GraphBatch
from hydragnn_tpu_torch.models import convs as C
from hydragnn_tpu_torch.models.convs import EdgeContext
from hydragnn_tpu_torch.models.layers import MLP, MaskedBatchNorm, lecun_normal_
from hydragnn_tpu_torch.ops.dynamic_radius import radius_graph_in_forward

KNOWN_MODELS = ("GIN", "PNA", "GAT", "MFC", "CGCNN", "SAGE", "SchNet")


@dataclasses.dataclass(frozen=True, eq=True)
class ModelConfig:
    """Static model configuration (the fields of the JAX package's
    ``ModelConfig`` that this slice reads)."""

    model_type: str
    input_dim: int
    hidden_dim: int
    output_dim: Tuple[int, ...]
    output_type: Tuple[str, ...]  # each "graph" | "node"
    output_names: Tuple[str, ...]
    task_weights: Tuple[float, ...]
    num_conv_layers: int = 16
    loss_function_type: str = "mse"
    graph_num_sharedlayers: int = 0
    graph_dim_sharedlayers: int = 0
    graph_num_headlayers: int = 0
    graph_dim_headlayers: Tuple[int, ...] = ()
    node_num_headlayers: int = 0
    node_dim_headlayers: Tuple[int, ...] = ()
    node_head_type: str = "mlp"
    num_nodes: Optional[int] = None
    edge_dim: Optional[int] = None
    gat_heads: int = 6
    gat_negative_slope: float = 0.05
    dropout: float = 0.25  # GAT's attention dropout
    max_neighbours: Optional[int] = None  # MFC max_degree
    pna_avg_deg_lin: float = 1.0
    pna_avg_deg_log: float = 1.0
    num_gaussians: Optional[int] = None
    num_filters: Optional[int] = None
    radius: Optional[float] = None
    inforward_radius: bool = False
    freeze_conv: bool = False
    fused_conv: bool = True
    conv_bf16: bool = False
    # accepted and recorded; nothing in the chassis reads it (BatchNorm
    # sits between the conv layers), as in the JAX package
    conv_residency: bool = False

    def __post_init__(self):
        if self.model_type not in KNOWN_MODELS:
            raise ValueError(f"Unknown model_type: {self.model_type}")
        if len(self.output_dim) != len(self.output_type) or len(self.output_dim) != len(
            self.output_names
        ):
            raise ValueError("output_dim/output_type/output_names length mismatch")
        if len(self.task_weights) != len(self.output_dim):
            raise ValueError(
                "Inconsistent number of loss weights and tasks: "
                f"{len(self.task_weights)} VS {len(self.output_dim)}"
            )
        if self.node_head_type == "mlp_per_node" and not self.num_nodes:
            raise ValueError("num_nodes must be positive integer for mlp_per_node")
        if self.inforward_radius and (self.radius is None or self.max_neighbours is None):
            raise ValueError("radius_graph_in_forward requires explicit radius and max_neighbours")
        if self.model_type == "CGCNN" and self.hidden_dim != self.input_dim:
            raise ValueError("CGCNN preserves width: hidden_dim must equal input_dim")
        if self.model_type == "CGCNN" and self.node_head_type == "conv" and "node" in self.output_type:
            raise ValueError("CGCNN does not support conv-type node heads")

    @property
    def use_edge_attr(self) -> bool:
        return self.edge_dim is not None and self.edge_dim > 0

    @property
    def num_heads(self) -> int:
        return len(self.output_dim)

    @property
    def normalized_weights(self) -> Tuple[float, ...]:
        total = sum(abs(w) for w in self.task_weights)
        return tuple(w / total for w in self.task_weights)


def _check_ported(cfg: ModelConfig) -> None:
    """Raise for a node head structure the chassis does not have."""
    if "node" in cfg.output_type and cfg.node_head_type not in ("mlp", "mlp_per_node", "conv"):
        raise ValueError(
            f"Unknown head NN structure for node features {cfg.node_head_type}; currently only "
            "support 'mlp', 'mlp_per_node' or 'conv'"
        )


class HydraModel(nn.Module):
    """Encoder + multi-head decoder (graph heads; node heads ``mlp``,
    ``mlp_per_node`` or ``conv``). GAT widens each encoder layer but the
    last by its heads (``concat``), as the JAX package does. Its
    attention dropout draws from a generator on the model's device,
    seeded once from ``dropout_seed``."""

    def __init__(
        self, cfg: ModelConfig, generator: Optional[torch.Generator] = None, dropout_seed: int = 1
    ):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        self.dropout_seed = int(dropout_seed)
        self._dropout_gen: Optional[torch.Generator] = None
        self.edge_group = None
        h = cfg.hidden_dim
        wide = h * cfg.gat_heads if cfg.model_type == "GAT" else h
        self.convs = nn.ModuleList()
        self.norms = nn.ModuleList()
        for layer in range(cfg.num_conv_layers):
            last = layer == cfg.num_conv_layers - 1
            fin = cfg.input_dim if layer == 0 else wide
            self.convs.append(self._make_conv(fin, h, generator, concat=not last))
            self.norms.append(MaskedBatchNorm(h if last else wide))
        self.graph_shared = None
        if "graph" in cfg.output_type:
            dims = (cfg.graph_dim_sharedlayers,) * cfg.graph_num_sharedlayers
            self.graph_shared = MLP(h, dims, relu_last=True, generator=generator)
            trunk_out = dims[-1] if dims else h
        heads = []
        for ihead in range(cfg.num_heads):
            out_dim = cfg.output_dim[ihead]
            if cfg.output_type[ihead] == "graph":
                dims = tuple(cfg.graph_dim_headlayers[: cfg.graph_num_headlayers]) + (out_dim,)
                heads.append(MLP(trunk_out, dims, generator=generator))
            else:
                dims = tuple(cfg.node_dim_headlayers[: cfg.node_num_headlayers]) + (out_dim,)
                if cfg.node_head_type == "mlp_per_node":
                    heads.append(PerNodeMLP(cfg.num_nodes, h, dims, generator))
                elif cfg.node_head_type == "conv":
                    # a GAT head's hidden convs concatenate their heads
                    k = cfg.gat_heads if cfg.model_type == "GAT" else 1
                    widths = tuple(d * k for d in dims[:-1]) + dims[-1:]
                    ins = (h,) + widths[:-1]
                    convs = [self._make_conv(a, b, generator, concat=j < len(dims) - 1)
                             for j, (a, b) in enumerate(zip(ins, dims))]
                    heads.append(ConvHead(convs, widths))
                else:
                    heads.append(MLP(h, dims, generator=generator))
        self.heads = nn.ModuleList(heads)

    def _make_conv(
        self, fin: int, out: int, generator: Optional[torch.Generator], concat: bool = True
    ) -> nn.Module:
        cfg = self.cfg
        mt = cfg.model_type
        if mt == "PNA":
            return C.PNAConv(
                fin, out, cfg.pna_avg_deg_lin, cfg.pna_avg_deg_log, generator,
                edge_dim=cfg.edge_dim if cfg.use_edge_attr else 0,
            )
        if mt == "GAT":
            return C.GATv2Conv(fin, out, cfg.gat_heads, cfg.gat_negative_slope, cfg.dropout, concat, generator)
        if mt == "GIN":
            return C.GINConv(fin, out, generator)
        if mt == "SAGE":
            return C.SAGEConv(fin, out, generator)
        if mt == "MFC":
            if cfg.max_neighbours is None:
                raise ValueError("MFC requires max_neighbours")
            return C.MFConv(fin, out, cfg.max_neighbours, generator)
        if mt == "CGCNN":
            return C.CGConv(fin, out, cfg.edge_dim if cfg.use_edge_attr else 0, generator)
        if mt == "SchNet":
            if not (cfg.num_gaussians and cfg.num_filters and cfg.radius):
                raise ValueError("SchNet requires num_gaussians, num_filters, and radius")
            return C.CFConv(fin, out, cfg.num_filters, cfg.num_gaussians, cfg.radius, generator)
        raise ValueError(mt)

    def _inforward_context(self, batch: GraphBatch) -> EdgeContext:
        """SchNet's interaction graph rebuilt from the positions
        (nearest ``max_neighbours`` within the radius, [N·K] slots), its
        distances and their Gaussian smearing; no occupancy bound, window
        plan or sender permutation applies to it."""
        cfg = self.cfg
        if batch.pos is None:
            raise ValueError("radius_graph_in_forward requires node positions; this batch has pos=None")
        n = batch.pos.shape[0]
        if n > 20_000:
            warnings.warn(
                f"radius_graph_in_forward is O(N_pad^2): node pad {n} implies ~{n ** 2 * 12 / 1e9:.1f} GB of "
                "pairwise temporaries (the [N,N,3] displacement tensor dominates); precompute edges on host "
                "for graphs this large (Architecture.radius_graph_in_forward=false)",
                RuntimeWarning,
                stacklevel=3,
            )
        senders, receivers, dist, edge_mask = radius_graph_in_forward(
            batch.pos, batch.node_graph, batch.node_mask, cfg.radius, cfg.max_neighbours
        )
        return EdgeContext(
            senders=senders,
            receivers=receivers,
            edge_mask=edge_mask,
            node_mask=batch.node_mask,
            in_degree=S.segment_count(receivers, n, edge_mask),
            edge_attr=C.gaussian_smearing(dist, 0.0, cfg.radius, cfg.num_gaussians),
            edge_weight=dist,
            fused_conv=cfg.fused_conv,
            conv_bf16=cfg.conv_bf16,
        )

    def edge_context(self, batch: GraphBatch) -> EdgeContext:
        """The layers' EdgeContext (the JAX package's ``_conv_args``,
        with SchNet's hook: the in-forward radius graph when configured;
        else distances from the edge features when the model takes them,
        or from the positions, then their Gaussian smearing)."""
        cfg = self.cfg
        if cfg.model_type == "SchNet" and cfg.inforward_radius:
            return self._inforward_context(batch)
        in_degree = batch.in_degree
        if in_degree is None:
            if self.edge_group is not None:
                raise ValueError("an edge-sharded batch must carry the whole graph's in_degree")
            in_degree = S.segment_count(batch.receivers, batch.num_nodes, batch.edge_mask)
        edge_attr = batch.edge_attr if cfg.use_edge_attr else None
        edge_weight = None
        if cfg.model_type == "SchNet":
            if cfg.use_edge_attr and batch.edge_attr is not None:
                edge_weight = torch.linalg.vector_norm(batch.edge_attr, dim=-1)
            elif batch.pos is not None:
                diff = batch.pos.index_select(0, batch.receivers.long()) - batch.pos.index_select(
                    0, batch.senders.long()
                )
                edge_weight = torch.linalg.vector_norm(diff, dim=-1)
            else:
                raise ValueError("SchNet requires edge_attr or node positions")
            edge_attr = C.gaussian_smearing(edge_weight, 0.0, cfg.radius, cfg.num_gaussians)
        degree_groups = None
        if cfg.model_type == "MFC":
            degree_groups = C.MFConv.degree_groups(in_degree, cfg.max_neighbours)
        dense_edge_attr = None
        if batch.dense_edge_attr is not None:
            dense_edge_attr = batch.dense_edge_attr.reshape(-1, batch.dense_edge_attr.shape[-1])
        return EdgeContext(
            senders=batch.senders,
            receivers=batch.receivers,
            edge_mask=batch.edge_mask,
            node_mask=batch.node_mask,
            in_degree=in_degree,
            edge_attr=edge_attr,
            edge_weight=edge_weight,
            sender_perm=batch.sender_perm,
            sender_win=batch.sender_win,
            edge_occ=batch.edge_occupancy,
            run_align=batch.run_align,
            dense_senders=batch.dense_senders,
            dense_mask=batch.dense_mask,
            dense_edge_attr=dense_edge_attr,
            dense_sender_perm=batch.dense_sender_perm,
            degree_groups=degree_groups,
            fused_conv=cfg.fused_conv,
            conv_bf16=cfg.conv_bf16,
            edge_group=self.edge_group,
        )

    def set_bn_group(self, group) -> None:
        """SyncBatchNorm: every MaskedBatchNorm reduces its batch
        statistics over ``group`` (None: this rank's alone)."""
        for m in self.modules():
            if isinstance(m, MaskedBatchNorm):
                m.group = group

    def set_edge_group(self, group) -> None:
        """Edge sharding (``parallel/edge_sharded.py``): the batch holds
        this rank's slice of the edges and every aggregation is reduced
        over ``group`` (None: the batch holds every edge)."""
        self.edge_group = group

    @property
    def uses_dropout(self) -> bool:
        return self.cfg.model_type == "GAT" and self.cfg.dropout > 0.0

    def dropout_generator(self, device: torch.device) -> torch.Generator:
        """The dropout generator on ``device``, seeded from
        ``dropout_seed`` at its first use there (its state is part of a
        checkpoint, ``utils/checkpoint.py``)."""
        if self._dropout_gen is None or self._dropout_gen.device != device:
            self._dropout_gen = torch.Generator(device=device).manual_seed(self.dropout_seed)
        return self._dropout_gen

    def _apply_conv(self, conv: nn.Module, x: torch.Tensor, ctx: EdgeContext, train: bool) -> torch.Tensor:
        if isinstance(conv, C.GATv2Conv):
            gen = self.dropout_generator(x.device) if train and conv.dropout > 0.0 else None
            return conv(x, ctx, train=train, generator=gen)
        return conv(x, ctx)

    def forward(
        self, batch: GraphBatch, train: bool = False, bn_train: Optional[bool] = None
    ) -> List[torch.Tensor]:
        """``train`` drives GAT's dropout; ``bn_train`` (default
        ``train``) selects masked batch statistics (True, which also
        updates the running statistics) or running statistics (False) in
        BatchNorm, so the statistics pass runs without dropout."""
        cfg = self.cfg
        bn = train if bn_train is None else bn_train
        ctx = self.edge_context(batch)
        x = batch.nodes
        for conv, norm in zip(self.convs, self.norms):
            x = self._apply_conv(conv, x, ctx, train)
            x = norm(x, mask=batch.node_mask, train=bn)
            x = torch.relu(x)

        outputs: List[torch.Tensor] = []
        graph_shared = None
        if self.graph_shared is not None:
            x_graph = S.segment_mean(x, batch.node_graph, batch.num_graphs, mask=batch.node_mask)
            graph_shared = self.graph_shared(x_graph)
        for ihead, head in enumerate(self.heads):
            if cfg.output_type[ihead] == "graph":
                outputs.append(head(graph_shared))
            elif isinstance(head, PerNodeMLP):
                outputs.append(head(x, batch))
            elif isinstance(head, ConvHead):
                outputs.append(head(x, lambda c, h_: self._apply_conv(c, h_, ctx, train), batch.node_mask, bn))
            else:
                outputs.append(head(x))
        return outputs


class ConvHead(nn.Module):
    """The ``conv`` node head (the JAX package's ``_node_head``): hidden
    convs, each followed by a masked BatchNorm (``widths``: a GAT head's
    hidden convs concatenate their heads) and ReLU, then the output conv
    and a masked BatchNorm, chained (x -> h1 -> ... -> out)."""

    def __init__(self, convs: Sequence[nn.Module], widths: Sequence[int]):
        super().__init__()
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(MaskedBatchNorm(d) for d in widths)

    def forward(self, x: torch.Tensor, apply_conv, node_mask: torch.Tensor, bn_train: bool):
        """``apply_conv(conv, x)`` runs one conv on the chassis' edge
        context."""
        last = len(self.convs) - 1
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            x = norm(apply_conv(conv, x), mask=node_mask, train=bn_train)
            if i < last:
                x = torch.relu(x)
        return x


class PerNodeMLP(nn.Module):
    """One MLP per intra-graph node position (the JAX package's
    ``PerNodeMLP``): stacked per-position weights ``w_{l}``
    [num_nodes, in, out] and ``b_{l}`` [num_nodes, out], flax's
    lecun-normal init (its fan-in of a 3-D kernel counts the stacked
    axis: num_nodes x in) and zero biases. Positions past ``num_nodes``
    (padding nodes) clip to the last.

    The position dispatch is one product per position over the nodes
    grouped by position (one sort, and one read of the counts to the
    host, per forward), not a per-node gather of the weights, which at
    hidden 128 would be [N, 128, 128]."""

    def __init__(
        self,
        num_nodes: int,
        in_dim: int,
        layer_dims: Sequence[int],
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.num_nodes = int(num_nodes)
        dims = (in_dim,) + tuple(layer_dims)
        self.num_layers = len(dims) - 1
        for li in range(self.num_layers):
            w = nn.Parameter(torch.empty(self.num_nodes, dims[li], dims[li + 1]))
            lecun_normal_(w, self.num_nodes * dims[li], generator)
            self.register_parameter(f"w_{li}", w)
            self.register_parameter(f"b_{li}", nn.Parameter(torch.zeros(self.num_nodes, dims[li + 1])))

    def forward(self, x: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
        n = x.shape[0]
        counts = batch.n_node.long()
        starts = torch.cumsum(counts, 0) - counts
        pos = torch.arange(n, device=x.device) - starts.index_select(0, batch.node_graph.long())
        pos = torch.clamp(pos, 0, self.num_nodes - 1)
        order = torch.argsort(pos, stable=True)
        sizes = torch.bincount(pos, minlength=self.num_nodes).tolist()
        h = x.index_select(0, order)
        for li in range(self.num_layers):
            w, b = getattr(self, f"w_{li}"), getattr(self, f"b_{li}")
            parts, start = [], 0
            for p, c in enumerate(sizes):
                if c:
                    parts.append(h[start : start + c] @ w[p] + b[p])
                    start += c
            h = torch.cat(parts, dim=0)
            if li < self.num_layers - 1:
                h = torch.relu(h)
        return torch.empty_like(h).index_copy(0, order, h)


def masked_loss(kind: str, pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean-reduced loss over the unmasked rows (the JAX package's
    ``masked_loss``)."""
    m = mask.to(pred.dtype)[:, None]
    denom = torch.clamp(m.sum() * pred.shape[1], min=1.0)
    diff = (pred - target) * m
    if kind == "mse":
        return (diff * diff).sum() / denom
    if kind == "mae":
        return diff.abs().sum() / denom
    if kind == "rmse":
        return torch.sqrt((diff * diff).sum() / denom)
    raise ValueError(f"Unknown loss function type: {kind}")


def model_loss(
    cfg: ModelConfig, outputs: Sequence[torch.Tensor], batch: GraphBatch
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(total, per-head losses): the weighted multi-task loss over masked
    heads, taken in f32 against f32 targets."""
    weights = cfg.normalized_weights
    tasks = []
    total = None
    for ihead in range(cfg.num_heads):
        name = cfg.output_names[ihead]
        if cfg.output_type[ihead] == "graph":
            target, mask = batch.graph_targets[name], batch.graph_mask
        else:
            target, mask = batch.node_targets[name], batch.node_mask
        head = masked_loss(cfg.loss_function_type, outputs[ihead].float(), target.float(), mask)
        tasks.append(head)
        total = weights[ihead] * head if total is None else total + weights[ihead] * head
    return total, tasks
