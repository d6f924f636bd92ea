"""Computation DAG of the port's models (port of
``repro/core/graphs.py``, the decoder-only LM part).

Node names of quantizable ops match the ``qops`` op names exactly (and hence
the param paths), so the partition output indexes straight into sensitivity
results and MP assignments. Non-quantizable vertices (norms, softmax,
elementwise merges, residual adds) are included because they shape the
single-entry/single-exit structure.

Residual adds are recorded as *residual edges* so the partitioner can drop
them (paper Fig. 6 note). The graph mirrors the *serving* (prefill)
computation: the multi-token prediction block and training-only ops are
left out, so MTP ops get sensitivities but no group, and are never
quantized (the reference's ``pipeline.build_groups`` drops them alike). The
port's ``LM`` builds attention and MLA blocks with dense MLPs or MoE
layers, so the graph covers exactly those; a mamba or hybrid configuration
and the encoder-decoder family raise with the slice that ports them.
"""
from __future__ import annotations

from repro_torch.core.partition import GraphSpec
from repro_torch.models.lm import LM, LMConfig

__all__ = ["build_graph", "build_lm_graph"]


def _attn_subgraph(g: GraphSpec, s: str, entry: str) -> str:
    """Standard attention: returns exit node name."""
    norm = g.add(f"{s}/attn_norm")
    g.edge(entry, norm)
    for proj in ("q_proj", "k_proj", "v_proj"):
        g.add(f"{s}/attn/{proj}", quantizable=True)
        g.edge(norm, f"{s}/attn/{proj}")
    qk = g.add(f"{s}/attn/qk_matmul", quantizable=True)
    g.edge(f"{s}/attn/q_proj", qk)
    g.edge(f"{s}/attn/k_proj", qk)
    sm = g.add(f"{s}/attn/softmax")
    g.edge(qk, sm)
    av = g.add(f"{s}/attn/av_matmul", quantizable=True)
    g.edge(sm, av)
    g.edge(f"{s}/attn/v_proj", av)
    o = g.add(f"{s}/attn/o_proj", quantizable=True)
    g.edge(av, o)
    return o


def _mla_subgraph(g: GraphSpec, s: str, entry: str) -> str:
    """DeepSeek-V3 latent attention: returns exit node name."""
    norm = g.add(f"{s}/attn_norm")
    g.edge(entry, norm)
    g.chain(norm, g.add(f"{s}/attn/q_a_proj", True), g.add(f"{s}/attn/q_norm"),
            g.add(f"{s}/attn/q_b_proj", True))
    g.chain(norm, g.add(f"{s}/attn/kv_a_proj", True),
            g.add(f"{s}/attn/kv_norm"), g.add(f"{s}/attn/kv_b_proj", True))
    qk = g.add(f"{s}/attn/qk_matmul", True)
    g.edge(f"{s}/attn/q_b_proj", qk)
    g.edge(f"{s}/attn/kv_b_proj", qk)
    sm = g.add(f"{s}/attn/softmax")
    g.edge(qk, sm)
    av = g.add(f"{s}/attn/av_matmul", True)
    g.edge(sm, av)
    g.edge(f"{s}/attn/kv_b_proj", av)
    o = g.add(f"{s}/attn/o_proj", True)
    g.edge(av, o)
    return o


def _mlp_subgraph(g: GraphSpec, s: str, entry: str, activation: str,
                  scope: str = "mlp") -> str:
    norm = g.add(f"{s}/mlp_norm")
    g.edge(entry, norm)
    if activation == "swiglu":
        gate = g.add(f"{s}/{scope}/gate_proj", True)
        up = g.add(f"{s}/{scope}/up_proj", True)
        g.edge(norm, gate)
        g.edge(norm, up)
        mul = g.add(f"{s}/{scope}/glu_mul")
        g.edge(gate, mul)
        g.edge(up, mul)
        pre_down = mul
    else:
        up = g.add(f"{s}/{scope}/up_proj", True)
        g.edge(norm, up)
        act = g.add(f"{s}/{scope}/act")
        g.edge(up, act)
        pre_down = act
    down = g.add(f"{s}/{scope}/down_proj", True)
    g.edge(pre_down, down)
    return down


def _moe_subgraph(g: GraphSpec, s: str, entry: str, activation: str,
                  shared: bool) -> str:
    """Router, dispatch, expert GEMMs and combine; shared experts on a
    parallel path merged with the routed output. Returns the exit node."""
    norm = g.add(f"{s}/mlp_norm")
    g.edge(entry, norm)
    router = g.add(f"{s}/moe/router", True)
    g.edge(norm, router)
    disp = g.add(f"{s}/moe/dispatch")
    g.edge(router, disp)
    gate = g.add(f"{s}/moe/experts/gate_proj", True)
    up = g.add(f"{s}/moe/experts/up_proj", True)
    g.edge(disp, gate)
    g.edge(disp, up)
    mul = g.add(f"{s}/moe/glu_mul")
    g.edge(gate, mul)
    g.edge(up, mul)
    down = g.add(f"{s}/moe/experts/down_proj", True)
    g.edge(mul, down)
    comb = g.add(f"{s}/moe/combine")
    g.edge(down, comb)
    if not shared:
        return comb
    sh = _mlp_subgraph(g, f"{s}/moe", norm, activation, scope="shared")
    merge = g.add(f"{s}/moe/shared_merge")
    g.edge(comb, merge)
    g.edge(sh, merge)
    return merge


def build_lm_graph(cfg: LMConfig) -> GraphSpec:
    """The DAG of a decoder of attention and MLA blocks, each with a dense
    MLP or an MoE layer (no weights needed)."""
    other = sorted(set(cfg.block_types) - {"attn", "mla"})
    if other or cfg.scan_layers:
        raise NotImplementedError(
            f"{cfg.name}: the graph of block types {other or ['attn/mla']} "
            f"with scan_layers={cfg.scan_layers} lands with the port slice "
            f"that ports them (mamba and hybrid: ROADMAP item A8; "
            f"scan_layers: A9)")
    g = GraphSpec()
    prev = g.add("embed")
    for i in range(cfg.n_layers):
        s = f"layers/{i}"
        block, is_moe = cfg.layer_signature(i)
        block_in = prev
        mix_out = (_mla_subgraph(g, s, prev) if block == "mla"
                   else _attn_subgraph(g, s, prev))
        add1 = g.add(f"{s}/residual_1")
        g.edge(mix_out, add1)
        g.edge(block_in, add1, residual=True)
        if is_moe:
            ffn_out = _moe_subgraph(g, s, add1, cfg.activation,
                                    cfg.moe.n_shared_experts > 0)
        elif cfg.d_ff > 0:
            ffn_out = _mlp_subgraph(g, s, add1, cfg.activation)
        else:
            prev = add1
            continue
        add2 = g.add(f"{s}/residual_2")
        g.edge(ffn_out, add2)
        g.edge(add1, add2, residual=True)
        prev = add2
    fn = g.add("final_norm")
    g.edge(prev, fn)
    head = g.add("lm_head", True)
    g.edge(fn, head)
    return g


def build_graph(model) -> GraphSpec:
    if isinstance(model, LM):
        return build_lm_graph(model.cfg)
    raise NotImplementedError(
        f"no computation graph for {type(model).__name__}: the port builds "
        f"decoder-only LMs; the encoder-decoder family lands with ROADMAP "
        f"item A8")
