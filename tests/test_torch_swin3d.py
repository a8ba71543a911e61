"""The Video Swin trunk (vqwild_tpu_torch/models/swin3d.py) and its training
through the port's VA path, against the plain reference
(tests/swin3d_reference.py, the published code's layout) on the CPU, from
seeded weights in which every leaf is non-zero (the bias tables too).

The grid: embedding width 16, three stages of two blocks (widths 16, 32,
64; heads 2, 2, 4), window 2x3x3, patch 2x4x4, clips of 6 frames of
40x36. Stage 1 is 3x10x9 tokens: padded to whole windows (4x12x9) and
shifted (1, 1, 1); its merge is odd-sized (W 9). Stage 2 is 3x5x5: padded
and shifted, then merged odd-sized again. Stage 3 is 3x3x3: H and W are no
larger than the window, so their shift is 0 there and only D shifts, as at
Swin-B's stage 4. Clips of 2 frames (one tubelet) shrink the window's D
too, so that ``index[:N, :N]`` is read at N < 18.

Tolerances, by dtype: float64 holds the port to the reference's rounding
(the two sum in other orders: attention through
``scaled_dot_product_attention`` with the bias as its mask against
explicit products, the patch conv as a matrix product); float32 allows
float32's rounding through six blocks, three Adam steps and the non-local
block's BatchNorm over 6 rows. The fault tests show a layout fault lies
orders of magnitude above both.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests import swin3d_reference as ref
from tests import test_torch_timesformer as tsf_test
from tests.test_torch_timesformer import gap, ref_state
from vqwild_tpu_torch.core import profiling
from vqwild_tpu_torch.core.config import ModelConfig
from vqwild_tpu_torch.models import fold, quant, swin3d
from vqwild_tpu_torch.models.arv import ARVModel, build_model
from vqwild_tpu_torch.ops import window_attention as window_ops
from vqwild_tpu_torch.retrieval.features import make_feat_fn
from vqwild_tpu_torch.train import step as step_mod
from vqwild_tpu_torch.train.step import create_train_state, make_optimizer, make_train_step

EMBED, DEPTHS, HEADS, WINDOW, PATCH = 16, (2, 2, 2), (2, 2, 4), (2, 3, 3), (2, 4, 4)
FRAMES, H, W = 6, 40, 36
DIM, NCLASS, BATCH = 64, 10, 6
TRUNK = dict(embed_dim=EMBED, depths=DEPTHS, heads=HEADS, window=WINDOW, patch=PATCH,
             mlp_ratio=4, drop_path=0.3, ln_eps=1e-5)
CFG = dict(TRUNK, dropout=0.5, nl_dropout=0.2, temperature=0.1, moving_average=0.9,
           init_lr=1e-4, weight_decay=1e-5)
# the largest gap over the largest entry: a forward, a gradient, a state.
# Read at this size: float64 forward 4e-16 to 7.5e-16, the trunk's
# gradients to 1.5e-15 (1.3e-14 by the third step), the heads' to 7e-12,
# losses equal; float32 forward 1.7e-7 to 3.6e-7, the trunk's gradients to
# 6e-7 (1.1e-4 by the third step), the heads' to 2.8e-3 (the non-local
# block's, through its BatchNorm over 6 rows), losses 1.8e-7 to 2.8e-6 (the
# third step's: three steps of drift); a layout fault 0.012 to 0.84
TOL = {torch.float64: dict(fwd=1e-13, grad=1e-9, state=1e-10, loss=1e-12),
       torch.float32: dict(fwd=2e-6, grad=5e-3, state=1e-3, loss=1e-5)}


def seeded_state(model, seed=7):
    """tests/test_torch_timesformer.seeded_state's draws (the bias tables
    as biases, normal at 0.1), each window's relative-position index kept."""
    sd = tsf_test.seeded_state(model, seed)
    sd.update({k: v for k, v in model.state_dict().items() if k.endswith("position_index")})
    return sd


def swin_model(method="va", dtype=torch.float32, seed=7):
    model = ARVModel(method, nclass=NCLASS, feat_dim=DIM, dtype=dtype, trunk="swin3d_b",
                     trunk_args=TRUNK)
    model.load_state_dict(seeded_state(model, seed))
    return model.to(dtype)


def planes(seed, batch=BATCH, frames=FRAMES):
    g = torch.Generator().manual_seed(seed)
    y = torch.randint(0, 256, (batch, frames, H, W), generator=g, dtype=torch.uint8)
    uv = torch.randint(0, 256, (batch, frames, H // 2, W // 2, 2), generator=g,
                       dtype=torch.uint8)
    return y, uv, torch.randint(0, NCLASS, (batch,), generator=g)


def masks(seed, batch=BATCH):
    return ref.draw_masks(torch.Generator().manual_seed(seed), batch,
                          ref.drop_path_rates(0.3, DEPTHS))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("frames", [FRAMES, 2])
def test_the_trunk_s_forward_matches_the_reference(dtype, frames):
    """Train mode with drop path (both draw the masks from one seed) and
    eval mode."""
    model = swin_model(dtype=dtype)
    P = ref_state(model, dtype)
    y, uv, _ = planes(1, frames=frames)
    x = ref.decode_yuv420(y, uv, dtype)
    for train in (True, False):
        fe, ce = model.embed(x, train=train, generator=torch.Generator().manual_seed(3))
        rfe, rce = ref.trunk(P, x, CFG, masks(3) if train else None)
        assert fe.shape == (BATCH, frames, DIM) and ce.shape == (BATCH, DIM)
        assert gap(fe, rfe) < TOL[dtype]["fwd"] and gap(ce, rce) < TOL[dtype]["fwd"]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_every_gradient_of_the_trunk_matches_the_reference(dtype):
    """Every trunk leaf's gradient of a seeded projection of both
    embeddings, drop path on; a leaf's gap over the median leaf's largest
    entry where its own is smaller (a bias under a LayerNorm or softmax)."""
    model = swin_model(dtype=dtype)
    P = {k: v.requires_grad_(v.is_floating_point()) for k, v in ref_state(model, dtype).items()}
    y, uv, _ = planes(2)
    x = ref.decode_yuv420(y, uv, dtype)
    g = torch.Generator().manual_seed(4)
    wf = torch.randn(BATCH, FRAMES, DIM, generator=g).to(dtype)
    wc = torch.randn(BATCH, DIM, generator=g).to(dtype)
    fe, ce = model.embed(x, train=True, generator=torch.Generator().manual_seed(5))
    ((fe * wf).sum() + (ce * wc).sum()).backward()
    rfe, rce = ref.trunk(P, x, CFG, masks(5))
    ((rfe * wf).sum() + (rce * wc).sum()).backward()
    trunk = {n: p for n, p in model.named_parameters() if n in P and P[n].grad is not None}
    assert len(trunk) == sum(1 for k in P if k.startswith(("patch_embed", "layers", "norm."))
                             and P[k].is_floating_point())
    scale = torch.stack([P[n].grad.abs().max() for n in trunk]).median()
    for n, p in trunk.items():
        want = P[n].grad
        assert float((p.grad - want).abs().max() / torch.maximum(want.abs().max(), scale)) \
            < TOL[dtype]["grad"], n


@pytest.mark.parametrize("shifted", [True, False], ids=["shifted", "unshifted"])
def test_the_attention_mask_is_contiguous(shifted):
    """The bias (and mask) a block hands SDPA is one contiguous [1, nW·heads,
    N, N] table: the card's memory-efficient kernel takes no mask whose last
    dimension is strided, and SDPA would fall back to its math path."""
    model = swin_model()
    blk = model.layers[0].blocks[1]
    mask = (window_ops.region_mask(swin3d.compute_regions((4, 12, 9), WINDOW, (1, 1, 1), "cpu"))
            if shifted else None)
    bias = blk.attn.bias(18, 24, mask, torch.float32)
    assert bias.shape == (1, 24 * HEADS[0], 18, 18) and bias.is_contiguous()


def test_every_gradient_keeps_its_leaf_s_layout():
    """Each trunk leaf's gradient has the leaf's strides. Adam's foreach
    updates take their multi-tensor launches only where every gradient
    does; one leaf read through a permuted view (the patch conv's weight)
    sends them over all leaves one launch a leaf, and on the card those
    thousand small launches empty the queue of work ahead of each step."""
    model = swin_model()
    y, uv, _ = planes(2)
    x = ref.decode_yuv420(y, uv, torch.float32)
    fe, ce = model.embed(x, train=True, generator=torch.Generator().manual_seed(5))
    leaves = {n: p for n, p in model.named_parameters()
              if n.startswith(("patch_embed", "layers", "norm."))}
    grads = torch.autograd.grad(fe.sum() + ce.sum(), list(leaves.values()))
    assert [n for (n, p), g in zip(leaves.items(), grads) if g.stride() != p.stride()] == []


@pytest.mark.parametrize("fault", ["unrolled_shift", "merge_order", "index_off_by_one"])
def test_a_layout_fault_in_the_reference_fails_the_comparison(fault):
    model = swin_model(dtype=torch.float64)
    P = ref_state(model, torch.float64)
    y, uv, _ = planes(1)
    x = ref.decode_yuv420(y, uv, torch.float64)
    fe, ce = model.embed(x)
    rfe, rce = ref.trunk(P, x, CFG, None, fault=fault)
    assert max(gap(fe, rfe), gap(ce, rce)) > 1e3 * TOL[torch.float32]["fwd"]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_three_train_steps_match_the_reference(dtype, monkeypatch):
    """make_train_step on the 4:2:0 wire, va, drop path on, from one
    generator seed: each step's loss and every leaf's gradient, then every
    parameter, the non-local BatchNorm's statistics and the visual memory
    after it, each step starting from the port's own state."""
    model = swin_model(dtype=dtype)
    P0 = ref_state(model, dtype)
    tx = make_optimizer(CFG["init_lr"], CFG["weight_decay"], 100, 9)
    state = create_train_state(model, tx, seed=11)
    step = make_train_step(model, tx, wire="yuv420")
    trainer = ref.VATrainer(P0, CFG, 11)
    names = [n for n, _ in model.named_parameters()]
    grads = []
    real = step_mod._optimizer_update
    monkeypatch.setattr(step_mod, "_optimizer_update",
                        lambda state, g, mesh=None: (grads.append(g), real(state, g, mesh))[1])
    tol = TOL[dtype]
    for i in range(3):
        y, uv, labels = planes(20 + i)
        state, losses = step(state, y, uv, labels)
        loss = trainer.step(y, uv, labels, dtype)
        assert abs(float(losses["loss"]) - loss) <= tol["loss"] * abs(loss)
        # a leaf whose gradient is nought but rounding (a key bias under
        # softmax, the non-local phi's bias) is held to the median leaf's scale
        scale = torch.stack([g.abs().max() for g in trainer.grads.values()]).median()
        for n, g in zip(names, grads[-1]):
            want = trainer.grads[n]
            assert float((g - want).abs().max() / torch.maximum(want.abs().max(), scale)) \
                < tol["grad"], (i, n)
        # as in tests/test_torch_timesformer.py: where rounding decides a
        # gradient's sign, Adam steps the two apart by up to lr a step
        null = {n for n, g in trainer.grads.items()
                if dtype == torch.float32 or g.abs().max() < 1e-3 * scale}
        cur = state.model.state_dict()
        for k, v in trainer.P.items():
            if k in null:
                assert float((cur[k] - v.detach()).abs().max()) <= 2 * CFG["init_lr"] * (i + 1), \
                    (i, k)
            elif v.is_floating_point():
                assert gap(cur[k], v.detach()) < tol["state"], (i, k)
            else:
                assert torch.equal(cur[k], v), (i, k)


def test_embeddings_through_make_feat_fn_unfolded():
    model = swin_model(dtype=torch.float32)
    P = ref_state(model, torch.float32)
    y, uv, _ = planes(5)
    feats = make_feat_fn(model, wire="yuv420", folded=False, device="cpu")(y.numpy(), uv.numpy())
    rfe, _ = ref.trunk(P, ref.decode_yuv420(y, uv), CFG)
    want = (rfe / rfe.norm(dim=-1, keepdim=True)).transpose(1, 2)
    assert feats.shape == (BATCH, DIM, FRAMES)
    assert gap(feats, want) < TOL[torch.float32]["fwd"]


def _published_layout(embed, depths, heads, window, patch, mlp_ratio=4):
    """(key, shape) of SwinTransformer3D's state_dict as the published code
    builds it (patch_norm=True, qkv_bias=True)."""
    table = (2 * window[0] - 1) * (2 * window[1] - 1) * (2 * window[2] - 1)
    n = window[0] * window[1] * window[2]
    out = [("patch_embed.proj.weight", (embed, 3) + tuple(patch)),
           ("patch_embed.proj.bias", (embed,)), ("patch_embed.norm.weight", (embed,)),
           ("patch_embed.norm.bias", (embed,))]
    for i, (depth, h) in enumerate(zip(depths, heads)):
        c = embed * 2 ** i
        for j in range(depth):
            b = f"layers.{i}.blocks.{j}"
            out += [(f"{b}.norm1.weight", (c,)), (f"{b}.norm1.bias", (c,)),
                    (f"{b}.attn.relative_position_bias_table", (table, h)),
                    (f"{b}.attn.relative_position_index", (n, n)),
                    (f"{b}.attn.qkv.weight", (3 * c, c)), (f"{b}.attn.qkv.bias", (3 * c,)),
                    (f"{b}.attn.proj.weight", (c, c)), (f"{b}.attn.proj.bias", (c,)),
                    (f"{b}.norm2.weight", (c,)), (f"{b}.norm2.bias", (c,)),
                    (f"{b}.mlp.fc1.weight", (mlp_ratio * c, c)),
                    (f"{b}.mlp.fc1.bias", (mlp_ratio * c,)),
                    (f"{b}.mlp.fc2.weight", (c, mlp_ratio * c)), (f"{b}.mlp.fc2.bias", (c,))]
        if i < len(depths) - 1:
            out += [(f"layers.{i}.downsample.reduction.weight", (2 * c, 4 * c)),
                    (f"layers.{i}.downsample.norm.weight", (4 * c,)),
                    (f"layers.{i}.downsample.norm.bias", (4 * c,))]
    c = embed * 2 ** (len(depths) - 1)
    return out + [("norm.weight", (c,)), ("norm.bias", (c,))]


def test_the_published_size_has_the_counted_parameters():
    """Swin-B (patch 2x4x4, window 8x7x7): 87,638,984 trunk parameters, by
    the equations and by the module, in the published keys and shapes."""
    with torch.device("meta"):
        model = ARVModel("va", nclass=200, feat_dim=1024, trunk="swin3d_b")
    heads_only = {"fc", "visual_memory", "cls_nl", "nled_fc"}
    trunk = {k: v for k, v in model.state_dict().items() if k.split(".")[0] not in heads_only}
    published = _published_layout(128, (2, 2, 18, 2), (4, 8, 16, 32), (8, 7, 7), (2, 4, 4))
    assert [(k, tuple(v.shape)) for k, v in trunk.items()] == published
    params = sum(v.numel() for k, v in trunk.items() if not k.endswith("position_index"))
    assert params == swin3d.param_count() == 87_638_984
    assert sum(p.numel() for p in swin3d.SwinTransformer3D().parameters()) == 87_638_984


def test_a_published_state_dict_loads_strict():
    """A state_dict in the published keys and shapes (the index at its
    published value) loads with strict=True, and the index is the
    reference's."""
    layout = _published_layout(EMBED, DEPTHS, HEADS, WINDOW, PATCH)
    g = torch.Generator().manual_seed(0)
    index = ref.relative_position_index(WINDOW)
    sd = {k: index.clone() if k.endswith("position_index") else torch.randn(s, generator=g)
          for k, s in layout}
    trunk = swin3d.SwinTransformer3D(DIM, **TRUNK)
    trunk.load_state_dict(sd, strict=True)
    assert torch.equal(trunk.layers[0].blocks[0].attn.relative_position_index, index)
    assert list(trunk.state_dict()) == [k for k, _ in layout]


def test_one_step_records_the_trunk_s_spans_and_counters():
    model = swin_model()
    tx = make_optimizer(1e-4, 1e-5, 100, 9)
    state = create_train_state(model, tx, seed=1)
    step = make_train_step(model, tx, wire="yuv420")
    y, uv, labels = planes(2)
    with profile(activities=[ProfilerActivity.CPU]):
        step(state, y, uv, labels)
    names = [s.name for s in profiling.spans()]
    assert names.count("swin.patch_embed") == 1
    assert names.count("swin.attn") == names.count("swin.mlp") == sum(DEPTHS)
    assert names.count("swin.merge") == len(DEPTHS) - 1
    assert all(s.parent == "step.forward" for s in profiling.spans()
               if s.name.startswith("swin."))
    # elements each layout copy writes a clip, worked by hand for this grid:
    # each stage's padded grid is written 3 times by its unshifted block
    # (pad, partition, reverse) and 5 times by its shifted one (pad, roll,
    # partition, reverse, roll back); a merge pads to even and gathers
    patches = 3 * 10 * 9 * 2 * 4 * 4 * 3
    grids = 4 * 12 * 9 * 16 + 4 * 6 * 6 * 32 + 4 * 3 * 3 * 64
    merges = (3 * 10 * 10 * 16 + 3 * 5 * 5 * 4 * 16) + (3 * 6 * 6 * 32 + 3 * 3 * 3 * 4 * 32)
    assert profiling.counters() == {
        "swin.tokens": BATCH * 3 * 10 * 9,
        "swin.attn.s1": 2, "swin.attn.s2": 2, "swin.attn.s3": 2,
        "swin.relayout_bytes": 4 * BATCH * (patches + 8 * grids + merges)}


def test_fold_and_the_int8_trunk_refuse_it():
    model = swin_model()
    sd = model.state_dict()
    y, uv, _ = planes(3)
    for call in (lambda: fold.fold_trunk_params(sd),
                 lambda: fold.make_embed_fn(sd, device="cpu"),
                 lambda: quant.calibrate_trunk(sd, y, uv, device="cpu"),
                 lambda: quant.quantize_trunk(sd, {}),
                 lambda: make_feat_fn(model, wire="yuv420", device="cpu"),
                 lambda: make_feat_fn(model, wire="yuv420", quant="int8", device="cpu")):
        with pytest.raises(ValueError, match="holds a Video Swin trunk"):
            call()


def test_build_model_and_the_command_line_build_it():
    swin = build_model(ModelConfig(method="vasa", nclass=NCLASS, feat_dim=DIM, semantic_dim=16,
                                   trunk="swin3d_b"), "cpu", seed=3, **TRUNK)
    assert swin.trunk_name == "swin3d_b" and swin.word_adaptor.fc.in_features == DIM
    assert swin.layers[2].blocks[1].drop_path == pytest.approx(0.3)
    out = swin(ref.decode_yuv420(*planes(4)[:2]))
    assert out.clip_embed.shape == (BATCH, DIM) and out.frame_embed.shape == (BATCH, FRAMES, DIM)
    with pytest.raises(ValueError, match="width 64 from 32"):
        ARVModel("va", feat_dim=DIM, trunk="swin3d_b", trunk_args=dict(TRUNK, embed_dim=32))
    from vqwild_tpu_torch.apps import cli

    argv = ["--method", "va", "--trunk", "swin3d_b", "--input_size", "32", "--train_frame", "2"]
    cfg = cli.parse(argv)[0]
    assert cfg.model.trunk == "swin3d_b" and cfg.model.feat_dim == 1024
    model = cli.build_arv_model(cfg, "cpu")
    assert model.trunk_name == "swin3d_b" and model.norm.normalized_shape == (1024,)
    assert swin3d.param_count() == sum(p.numel() for n, p in model.named_parameters()
                                       if n.split(".")[0] in ("patch_embed", "layers", "norm"))
    with pytest.raises(ValueError, match="--pretrained_weights takes the ResNet18-F2F .* "
                                         "Video Swin"):
        cli.build_arv_model(cli.parse(argv + ["--pretrained_weights", "r18.pth"])[0], "cpu")

