"""The TimeSformer trunk (vqwild_tpu_torch/models/timesformer.py) and its
training through the port's VA path, against the plain reference
(tests/timesformer_reference.py, the published code's layout) on the CPU,
at D 64, 4 heads, 2 blocks, MLP 256, 4 frames of 32x32 in patches of 8,
from seeded weights in which every leaf is non-zero.

Tolerances, by dtype: float64 holds the port to the reference's rounding
(the two sum in other orders: attention through
``scaled_dot_product_attention`` against explicit products, the patch conv
as a matrix product); float32 allows float32's rounding through two
blocks, three Adam steps and the non-local block's BatchNorm over 6 rows.
The fault tests show a layout fault lies orders of magnitude above both.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests import timesformer_reference as ref
from vqwild_tpu_torch.core import profiling
from vqwild_tpu_torch.core.config import ModelConfig
from vqwild_tpu_torch.models import fold, heads, quant, timesformer
from vqwild_tpu_torch.models.arv import ARVModel, build_model
from vqwild_tpu_torch.models.convert import load_reference_model, save_reference_checkpoint
from vqwild_tpu_torch.models.resnet_f2f import ResNet18F2F
from vqwild_tpu_torch.retrieval.features import make_feat_fn
from vqwild_tpu_torch.train import step as step_mod
from vqwild_tpu_torch.train.step import create_train_state, make_optimizer, make_train_step

DIM, DEPTH, HEADS, MLP, PATCH, FRAMES, CROP = 64, 2, 4, 256, 8, 4, 32
NCLASS, BATCH = 10, 6
# drop path at 0.3 (0.1 published) so that block 1's masks drop rows
TRUNK = dict(depth=DEPTH, heads=HEADS, mlp=MLP, patch=PATCH, frames=FRAMES, crop=CROP,
             drop_path=0.3, ln_eps=1e-6)
CFG = dict(TRUNK, dropout=0.5, nl_dropout=0.2, temperature=0.1, moving_average=0.9,
           init_lr=1e-4, weight_decay=1e-5)
N_PATCH = (CROP // PATCH) ** 2
# the largest gap over the largest entry: a forward, a gradient, a state.
# Read at this size: float64 forward 3e-16 to 9e-16, gradients 2.7e-12,
# losses equal; float32 forward 1.3e-7 to 3.1e-7, gradients 7e-4 to 1.2e-3
# (the non-local block's, through its BatchNorm over 6 rows), losses 1e-7
# to 1.2e-6; a layout fault 0.06 to 0.86
TOL = {torch.float64: dict(fwd=1e-13, grad=1e-9, state=1e-10, loss=1e-12),
       torch.float32: dict(fwd=2e-6, grad=5e-3, state=1e-3, loss=5e-6)}


def seeded_state(model, seed=7):
    """Every leaf of ``model``'s state_dict drawn from ``seed``: linears
    uniform in ±1/sqrt(fan-in), LayerNorm weights in [0.5, 1.5), biases,
    embeddings and statistics normal, the memory's rows unit vectors."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in model.state_dict().items():
        if v.dtype == torch.long:
            out[k] = torch.zeros_like(v)
        elif k == "visual_memory":
            a = torch.randn(v.shape, generator=g)
            out[k] = a / a.norm(dim=-1, keepdim=True)
        elif k.endswith("running_var") or (k.endswith(".weight") and v.dim() == 1):
            out[k] = 0.5 + torch.rand(v.shape, generator=g)
        elif k.endswith(".weight"):
            fan_in = v[0].numel()
            out[k] = (2 * torch.rand(v.shape, generator=g) - 1) / fan_in ** 0.5
        else:
            out[k] = 0.1 * torch.randn(v.shape, generator=g)
        out[k] = out[k].to(v.dtype)
    return out


def tsf_model(method="va", dtype=torch.float32, seed=7):
    model = ARVModel(method, nclass=NCLASS, feat_dim=DIM, dtype=dtype, trunk="timesformer_divst",
                     trunk_args=TRUNK)
    model.load_state_dict(seeded_state(model, seed))
    return model.to(dtype)


def planes(seed, batch=BATCH, frames=FRAMES):
    g = torch.Generator().manual_seed(seed)
    y = torch.randint(0, 256, (batch, frames, CROP, CROP), generator=g, dtype=torch.uint8)
    uv = torch.randint(0, 256, (batch, frames, CROP // 2, CROP // 2, 2), generator=g,
                       dtype=torch.uint8)
    return y, uv, torch.randint(0, NCLASS, (batch,), generator=g)


def gap(a, b):
    a, b = torch.as_tensor(a).detach().double(), torch.as_tensor(b).detach().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def ref_state(model, dtype):
    return {k: v.detach().clone().to(dtype if v.is_floating_point() else v.dtype)
            for k, v in model.state_dict().items()}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_the_trunk_s_forward_matches_the_reference(dtype):
    """Train mode with drop path (both draw the masks from one seed) and
    eval mode."""
    model = tsf_model(dtype=dtype)
    P = ref_state(model, dtype)
    y, uv, _ = planes(1)
    x = ref.decode_yuv420(y, uv, dtype)
    for train in (True, False):
        fe, ce = model.embed(x, train=train, generator=torch.Generator().manual_seed(3))
        masks = (ref.draw_masks(torch.Generator().manual_seed(3), BATCH, FRAMES, N_PATCH,
                                ref.drop_path_rates(0.3, DEPTH)) if train else None)
        rfe, rce = ref.trunk(P, x, CFG, masks)
        assert fe.shape == (BATCH, FRAMES, DIM) and ce.shape == (BATCH, DIM)
        assert gap(fe, rfe) < TOL[dtype]["fwd"] and gap(ce, rce) < TOL[dtype]["fwd"]


@pytest.mark.parametrize("fault", ["frame_major", "cls_first_frame"])
def test_a_layout_fault_in_the_reference_fails_the_comparison(fault):
    model = tsf_model(dtype=torch.float64)
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
    model = tsf_model(dtype=dtype)
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
        # Adam moves a coordinate by up to lr a step whatever its gradient's
        # size, so where rounding decides a gradient's sign (a leaf whose
        # gradient is nought but rounding; in float32 also the non-local
        # block's, through a BatchNorm over 6 near-identical rows) the port
        # and the reference may step apart: those are held to 2 lr a step,
        # their gradients to the tolerance above
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
    model = tsf_model(dtype=torch.float32)
    P = ref_state(model, torch.float32)
    y, uv, _ = planes(5)
    feats = make_feat_fn(model, wire="yuv420", folded=False, device="cpu")(y.numpy(), uv.numpy())
    rfe, _ = ref.trunk(P, ref.decode_yuv420(y, uv), CFG)
    want = (rfe / rfe.norm(dim=-1, keepdim=True)).transpose(1, 2)
    assert feats.shape == (BATCH, DIM, FRAMES)
    assert gap(feats, want) < TOL[torch.float32]["fwd"]
    # other clip lengths read time_embed interpolated, as the published code does
    y8, uv8, _ = planes(5, batch=2, frames=2 * FRAMES)
    assert make_feat_fn(model, wire="yuv420", folded=False, device="cpu")(
        y8.numpy(), uv8.numpy()).shape == (2, DIM, 2 * FRAMES)


def test_the_published_size_has_the_counted_parameters():
    """vit_base_patch16_224 with divided space-time attention at 8 frames:
    121,258,752 trunk parameters, by the equations and by the module."""
    with torch.device("meta"):
        model = ARVModel("va", nclass=200, feat_dim=768, trunk="timesformer_divst")
    heads_only = {"fc", "visual_memory", "cls_nl", "nled_fc"}
    trunk = {k: v for k, v in model.state_dict().items() if k.split(".")[0] not in heads_only}
    attention = 768 * 2304 + 2304 + 768 * 768 + 768
    per_block = 6 * 768 + 2 * attention + 768 * 768 + 768 + 2 * 768 * 3072 + 3072 + 768
    embed = 3 * 16 * 16 * 768 + 768 + 768 + 197 * 768 + 8 * 768
    assert sum(v.numel() for v in trunk.values()) == embed + 12 * per_block + 2 * 768
    assert timesformer.param_count() == embed + 12 * per_block + 2 * 768 == 121_258_752
    assert {k.split(".")[0] for k in trunk} == {"cls_token", "pos_embed", "time_embed",
                                                "patch_embed", "blocks", "norm"}
    assert sorted({k.split(".", 2)[2].rsplit(".", 1)[0] for k in trunk
                   if k.startswith("blocks.0.")}) == [
        "attn.proj", "attn.qkv", "mlp.fc1", "mlp.fc2", "norm1", "norm2", "temporal_attn.proj",
        "temporal_attn.qkv", "temporal_fc", "temporal_norm1"]


def test_one_step_records_the_trunk_s_spans_and_counters():
    model = tsf_model()
    tx = make_optimizer(1e-4, 1e-5, 100, 9)
    state = create_train_state(model, tx, seed=1)
    step = make_train_step(model, tx, wire="yuv420")
    y, uv, labels = planes(2)
    with profile(activities=[ProfilerActivity.CPU]):
        step(state, y, uv, labels)
    names = [s.name for s in profiling.spans()]
    assert names.count("tsf.patch_embed") == 1
    for part in ("tsf.temporal", "tsf.spatial", "tsf.mlp"):
        assert names.count(part) == DEPTH
    assert all(s.parent == "step.forward" for s in profiling.spans() if s.name.startswith("tsf."))
    tokens = BATCH * N_PATCH * FRAMES
    gather = BATCH * FRAMES * (N_PATCH + 1) * DIM  # a block's spatial gather, in elements
    patches = tokens * PATCH * PATCH * 3 + DIM * PATCH * PATCH * 3  # the patch gather and weight
    assert profiling.counters() == {"tsf.tokens": tokens + BATCH, "tsf.attn.temporal": DEPTH,
                                    "tsf.attn.spatial": DEPTH,
                                    "tsf.relayout_bytes": 4 * (patches + DEPTH * gather)}


def test_fold_and_the_int8_trunk_refuse_it():
    model = tsf_model()
    sd = model.state_dict()
    y, uv, _ = planes(3)
    for call in (lambda: fold.fold_trunk_params(sd),
                 lambda: fold.make_embed_fn(sd, device="cpu"),
                 lambda: quant.calibrate_trunk(sd, y, uv, device="cpu"),
                 lambda: quant.quantize_trunk(sd, {}),
                 lambda: make_feat_fn(model, wire="yuv420", device="cpu"),
                 lambda: make_feat_fn(model, wire="yuv420", quant="int8", device="cpu")):
        with pytest.raises(ValueError, match="TimeSformer"):
            call()


@pytest.mark.parametrize("method", ["va", "vasa"])
def test_the_resnet_model_s_keys_are_the_reference_checkpoint_s(method, tmp_path):
    """The default trunk is the ResNet18-F2F, its keys at the top level in
    the reference checkpoint's order, then the heads; a best.pth.tar
    round-trips through load_reference_model (strict)."""
    model = ARVModel(method, nclass=NCLASS, semantic_dim=16)
    want = ["visual_memory"] + list(ResNet18F2F().state_dict()) + ["fc.weight", "fc.bias"]
    want += ["cls_nl." + k for k in heads.NonLocal1D(512, 512).state_dict()]
    want += ["nled_fc.weight", "nled_fc.bias"]
    if method == "vasa":
        want += ["word_adaptor." + k for k in heads.SemanticAdaptor(16).state_dict()]
    assert list(model.state_dict()) == want
    path = str(tmp_path / "best.pth.tar")
    save_reference_checkpoint(path, model, method)
    back = load_reference_model(path, method, device="cpu")
    assert all(torch.equal(v, back.state_dict()[k]) for k, v in model.state_dict().items())


def test_build_model_builds_either_trunk():
    tsf = build_model(ModelConfig(method="vasa", nclass=NCLASS, feat_dim=DIM, semantic_dim=16,
                                  trunk="timesformer_divst"), "cpu", seed=3, **TRUNK)
    assert tsf.trunk_name == "timesformer_divst" and tsf.blocks[1].drop_path == pytest.approx(0.3)
    assert tsf.word_adaptor.fc.in_features == DIM
    out = tsf(ref.decode_yuv420(*planes(4)[:2]))
    assert out.clip_embed.shape == (BATCH, DIM) and out.frame_embed.shape == (BATCH, FRAMES, DIM)
    again = build_model(ModelConfig(method="vasa", nclass=NCLASS, feat_dim=DIM, semantic_dim=16,
                                    trunk="timesformer_divst"), "cpu", seed=3, **TRUNK)
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in tsf.state_dict().items())
    assert build_model(ModelConfig(method="va"), "cpu").trunk_name == "resnet18_f2f"
    with pytest.raises(ValueError, match="unknown trunk"):
        ARVModel("va", trunk="vit")


def test_the_command_line_takes_the_trunk():
    from vqwild_tpu_torch.apps import cli

    cfg, _ = cli.parse(["--method", "va", "--trunk", "timesformer_divst", "--input_size", "224",
                        "--train_frame", "8"])
    assert cfg.model.trunk == "timesformer_divst" and cfg.model.feat_dim == 768
    cfg, _ = cli.parse(["--method", "va"])
    assert cfg.model.trunk == "resnet18_f2f" and cfg.model.feat_dim == 512
