"""The port's streaming VAE decode and batch slicing on the CPU: the cases of
tests/test_stream_decode.py on `videopainter_tpu_torch`.

`VAEStreamDecoder` must emit exactly what `decode(z_full)` gives (the same
frame-batch boundaries, carried conv caches, per-tile caches and in-place
blending under tiling) however the latent frames are split across `feed`
calls, with and without the host spill of the caches; the any-length
pipeline's `stream_decode` must give the pixels of its one-shot decode,
also with the VAE on `vae_device`. Every such comparison is `torch.equal` /
`assert_array_equal`: the same operations on the same values. Slicing
decodes (and encodes) a batch one sample at a time: bit-equal to each sample
decoded alone, and within fp32 rounding of the batched call (atol 2e-5 on
values of a few units: a batch of 2 takes other convolution blockings).
"""

import numpy as np
import pytest
import torch

import videopainter_tpu_torch.config as tcfg
from videopainter_tpu_torch.models import (AutoencoderKLCogVideoX, CogVideoXBranch,
                                           CogVideoXTransformer3D, VAEStreamDecoder)
from videopainter_tpu_torch.pipelines import CogVideoXI2VDualInpaintAnyLPipeline
from videopainter_tpu_torch.schedulers import CogVideoXDPMScheduler


VAE_CFG = tcfg.VAEConfig.tiny(latent_channels=16)


@pytest.fixture(scope="module")
def vae():
    return AutoencoderKLCogVideoX(VAE_CFG).init_random_(torch.Generator().manual_seed(3)).eval()


def latents(seed, shape):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def stream(vae, z, splits, **kw):
    streamer = vae.stream_decoder(z.shape[1], **kw)
    outs, s = [], 0
    for n in splits:
        got = streamer.feed(z[:, s:s + n])
        if got is not None:
            outs.append(got)
        s += n
    assert streamer.next_chunk == len(streamer.boundaries) and streamer.fed == z.shape[1]
    return torch.cat(outs, dim=1), streamer


@pytest.mark.parametrize("total_t,splits", [
    (5, [2, 2, 1]),
    (5, [5]),
    (7, [1, 1, 1, 1, 1, 1, 1]),
    (6, [4, 2]),
])
def test_stream_matches_oneshot(vae, total_t, splits):
    assert sum(splits) == total_t
    z = latents(0, (1, total_t, 8, 12, 16))
    ref = vae.decode(z)
    ours, streamer = stream(vae, z, splits)
    # the one-shot decode's frame batches: 2 latent frames, the remainder first
    rem = total_t % 2
    assert streamer.boundaries[0] == (0, 2 + rem) and streamer.boundaries[-1][1] == total_t
    assert ours.shape == ref.shape
    assert torch.equal(ours, ref)


def test_stream_matches_oneshot_tiled(vae):
    vae.enable_tiling(tile_sample_min_height=48, tile_sample_min_width=64)
    try:
        z = latents(1, (1, 5, 12, 18, 16))
        ref = vae.decode(z)
        ours, streamer = stream(vae, z, [3, 2])
        assert len(streamer.caches) > 1   # one cache per spatial tile
        assert torch.equal(ours, ref)
    finally:
        vae.disable_tiling()


def test_stream_cache_spill_bitexact(vae):
    """The caches go to host memory after each chunk and come back before the
    next: plain copies, so the frames are bit-identical."""
    vae.enable_tiling(tile_sample_min_height=48, tile_sample_min_width=64)
    try:
        z = latents(2, (1, 5, 12, 18, 16))
        ref = vae.decode(z)
        ours, streamer = stream(vae, z, [2, 2, 1], cache_spill=True)
        assert torch.equal(ours, ref)
        leaves = []

        def walk(c):
            if isinstance(c, dict):
                for v in c.values():
                    walk(v)
            elif c is not None:
                leaves.append(c)
        walk(streamer.caches)
        assert leaves and all(t.device.type == "cpu" for t in leaves)
        # a spilled cache is a copy, not the decoder's own tensor
        cache = {"a": torch.ones(3), "b": {"c": None}}
        spilled = VAEStreamDecoder._spill(cache)
        assert torch.equal(spilled["a"], cache["a"]) and spilled["a"] is not cache["a"]
        assert spilled["b"]["c"] is None
    finally:
        vae.disable_tiling()


def test_stream_overfeed_raises(vae):
    streamer = vae.stream_decoder(3)
    assert streamer.feed(torch.zeros((1, 2, 8, 12, 16))) is None   # the first chunk has 3
    with pytest.raises(ValueError, match="total_t"):
        streamer.feed(torch.zeros((1, 2, 8, 12, 16)))
    with pytest.raises(ValueError, match="total_t >= 2"):
        vae.stream_decoder(1)


def test_slicing_equals_the_batched_call(vae):
    z = latents(4, (2, 3, 8, 12, 16))
    x = latents(5, (2, 9, 64, 96, 3)).clamp(-1, 1)
    batched_dec, batched_enc = vae.decode(z), vae.encode(x)
    alone_dec = torch.cat([vae.decode(z[i:i + 1]) for i in range(2)])
    alone_enc = [torch.cat(t) for t in zip(*(vae.encode(x[i:i + 1]) for i in range(2)))]
    vae.enable_slicing()
    try:
        assert vae.use_slicing
        dec, enc = vae.decode(z), vae.encode(x)
    finally:
        vae.disable_slicing()
    assert not vae.use_slicing
    assert torch.equal(dec, alone_dec)
    assert torch.equal(enc.mean, alone_enc[0]) and torch.equal(enc.logvar, alone_enc[1])
    torch.testing.assert_close(dec, batched_dec, rtol=0, atol=2e-5)
    torch.testing.assert_close(enc.mean, batched_enc.mean, rtol=0, atol=2e-5)
    torch.testing.assert_close(enc.logvar, batched_enc.logvar, rtol=0, atol=2e-5)


# -- the any-length pipeline's stream_decode ------------------------------------------------

@pytest.fixture(scope="module")
def anyl_pipe():
    gen = torch.Generator().manual_seed(0)
    tt = tcfg.TransformerConfig.tiny(in_channels=32, out_channels=16, sample_height=8,
                                     sample_width=12)
    transformer = CogVideoXTransformer3D(tt).init_random_(gen)
    branch = CogVideoXBranch(tcfg.BranchConfig.from_transformer(tt, num_layers=2))
    branch.init_random_(gen)
    branch.init_from_transformer(transformer)
    vae = AutoencoderKLCogVideoX(VAE_CFG).init_random_(gen)
    sched = CogVideoXDPMScheduler(tcfg.SchedulerConfig.cogvideox_5b_inference())
    return CogVideoXI2VDualInpaintAnyLPipeline(transformer, branch, vae, sched, device="cpu")


def anyl_kw(seed, frames=17):
    rng = np.random.RandomState(seed)
    video = torch.from_numpy(rng.rand(1, frames, 64, 96, 3).astype(np.float32)) * 2 - 1
    masks = np.zeros((1, frames, 64, 96), np.float32)
    masks[:, :, 16:40, 24:64] = 1.0
    embeds = torch.from_numpy(rng.rand(1, 5, 12).astype(np.float32))
    return dict(video=video, masks=torch.from_numpy(masks), image=video[:, 0], num_frames=9,
                prompt_embeds=embeds, negative_prompt_embeds=torch.zeros_like(embeds),
                num_inference_steps=2, guidance_scale=6.0, replace_gt=True,
                vae_sample_mode="mode", use_flash=True)


@pytest.mark.parametrize("stride", [8, 4])
def test_anyl_stream_decode_matches(anyl_pipe, stride):
    """Windows that meet (stride 8) and overlap (stride 4: the decode lags a
    window): the streamed frames equal the one-shot decode's; the decode
    happens window by window, and the streamed caches are spilled (no
    vae_device)."""
    kw = anyl_kw(0)
    ref = anyl_pipe(**kw, generator=torch.Generator().manual_seed(7), stride=stride)
    feeds = []
    feed = VAEStreamDecoder.feed

    def recorded(self, z):
        feeds.append((z.shape[1], self.cache_spill))
        return feed(self, z)

    VAEStreamDecoder.feed = recorded
    try:
        out = anyl_pipe(**kw, generator=torch.Generator().manual_seed(7), stride=stride,
                        stream_decode=True)
    finally:
        VAEStreamDecoder.feed = feed
    n_windows = (17 - 9) // stride + 1
    assert len(feeds) == n_windows and all(spill for _, spill in feeds)
    assert sum(n for n, _ in feeds) == 5   # the latent frames of the 17-frame timeline
    assert out.shape == ref.shape == (1, 17, 64, 96, 3)
    np.testing.assert_array_equal(out, ref)


def test_anyl_stream_decode_on_vae_device(anyl_pipe):
    """vae_device: the streamed decode runs on the given device's copy of the
    VAE (the CPU here), without the spill unless asked; same frames."""
    kw = anyl_kw(1)
    ref = anyl_pipe(**kw, generator=torch.Generator().manual_seed(5), stride=8,
                    output_type="pt")
    for spill in (None, True):
        out = anyl_pipe(**kw, generator=torch.Generator().manual_seed(5), stride=8,
                        output_type="pt", stream_decode=True, vae_device="cpu",
                        stream_cache_spill=spill)
        assert isinstance(out, torch.Tensor) and out.device == ref.device
        assert torch.equal(out, ref)
