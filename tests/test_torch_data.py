"""The port's input pipeline (``metis_tpu_torch/data/pipeline.py``) against
the JAX package's ``metis_tpu.data.pipeline``: the reference's cases of
``tests/test_data.py``, and the same seed giving the same batches — the
same windows, the same shuffled order, the same fast-forward."""
import threading
import time

import numpy as np
import pytest
import torch

from metis_tpu.data import pipeline as jpipe
from metis_tpu_torch.data import pipeline as tpipe
from metis_tpu_torch.data.pipeline import (
    TokenDataset,
    batches_per_epoch,
    make_input_pipeline,
    measure_batch_generator_ms,
    synthetic_run_dataset,
)


def _firsts(it):
    return [np.asarray(t)[:, 0].tolist() for t, _ in it]


class TestDataset:
    def test_windows_and_targets_shift(self):
        ds = TokenDataset(np.arange(101, dtype=np.int32), seq_len=10)
        assert ds.num_windows == 10
        toks, tgts = ds.window(3)
        np.testing.assert_array_equal(toks, np.arange(30, 40))
        np.testing.assert_array_equal(tgts, np.arange(31, 41))

    def test_too_short_stream_rejected(self):
        with pytest.raises(ValueError, match="window"):
            TokenDataset(np.arange(5, dtype=np.int32), seq_len=10)

    def test_synthetic_run_dataset_matches_the_reference(self):
        """The synthetic stream of train runs: the reference's tokens, a
        fixed ``SYNTHETIC_SCHEDULE_BATCHES`` batches per epoch."""
        got = synthetic_run_dataset(64, 4, 16)
        want = jpipe.synthetic_run_dataset(64, 4, 16)
        np.testing.assert_array_equal(got.tokens, want.tokens)
        assert tpipe.SYNTHETIC_SCHEDULE_BATCHES == jpipe.SYNTHETIC_SCHEDULE_BATCHES
        assert batches_per_epoch(got, 4) == tpipe.SYNTHETIC_SCHEDULE_BATCHES


class TestPipeline:
    def test_epoch_covers_each_window_once(self):
        ds = TokenDataset(np.arange(161, dtype=np.int32), seq_len=10)  # 16 win
        assert batches_per_epoch(ds, 4) == 4
        seen = []
        for toks, tgts in make_input_pipeline(ds, gbs=4, epochs=1):
            assert toks.shape == (4, 10)
            np.testing.assert_array_equal(toks[:, 1:], tgts[:, :-1])
            seen.extend(toks[:, 0].tolist())
        assert sorted(seen) == sorted((np.arange(16) * 10).tolist())

    @pytest.mark.parametrize("seed", [None, 0, 3])
    def test_same_seed_gives_the_reference_batches(self, seed):
        """Every batch of two epochs, tokens and targets, equal to the
        reference's for the same stream and seed."""
        stream = np.random.default_rng(5).integers(0, 50, 1601, dtype=np.int32)
        got = list(make_input_pipeline(TokenDataset(stream, 10), 8,
                                       shuffle_seed=seed, epochs=2))
        want = list(jpipe.make_input_pipeline(jpipe.TokenDataset(stream, 10), 8,
                                              shuffle_seed=seed, epochs=2))
        assert len(got) == len(want) == 40
        for (gt, gg), (wt, wg) in zip(got, want):
            np.testing.assert_array_equal(gt, wt)
            np.testing.assert_array_equal(gg, wg)

    def test_skip_batches_fast_forwards_deterministically(self):
        """``skip_batches=k`` yields exactly the stream from batch k on, the
        reference's too: same seed, mid-epoch start, the epoch boundary
        crossed (16 windows / gbs 4 = 4 per epoch; skip 6 lands in epoch 1,
        batch 2)."""
        ds = TokenDataset(np.arange(161, dtype=np.int32), seq_len=10)
        jds = jpipe.TokenDataset(np.arange(161, dtype=np.int32), seq_len=10)
        full = _firsts(make_input_pipeline(ds, 4, shuffle_seed=3, epochs=2))
        for skip in (1, 3, 6):
            skipped = _firsts(make_input_pipeline(ds, 4, shuffle_seed=3, epochs=2,
                                                  skip_batches=skip))
            assert skipped == full[skip:], f"skip={skip}"
            assert skipped == _firsts(jpipe.make_input_pipeline(
                jds, 4, shuffle_seed=3, epochs=2, skip_batches=skip))

    def test_shuffle_changes_order_not_content(self):
        ds = TokenDataset(np.arange(161, dtype=np.int32), seq_len=10)
        a = _firsts(make_input_pipeline(ds, 4, shuffle_seed=1, epochs=1))
        b = _firsts(make_input_pipeline(ds, 4, shuffle_seed=2, epochs=1))
        assert a != b
        assert sorted(sum(a, [])) == sorted(sum(b, []))

    def test_placement_on_the_device(self):
        """With ``device`` the batches are int32 tensors on it, the whole
        batch that the port's executors cut into each rank's part."""
        ds = TokenDataset.synthetic(64, 2000, 16)
        whole = next(make_input_pipeline(ds, gbs=8, epochs=1))
        toks, tgts = next(make_input_pipeline(ds, gbs=8, device="cpu", epochs=1))
        assert isinstance(toks, torch.Tensor) and toks.dtype == torch.int32
        assert toks.device.type == "cpu" and toks.shape == (8, 16)
        np.testing.assert_array_equal(toks.numpy(), whole[0])
        np.testing.assert_array_equal(tgts.numpy(), whole[1])

    def test_trains_a_model(self):
        """The pipeline feeds the port's one-device train step."""
        from metis_tpu_torch.core.types import UniformPlan
        from metis_tpu_torch.execution.builder import build_executable
        from metis_tpu_torch.execution.mesh import PlanArtifact
        from metis_tpu_torch.models.gpt import GPTConfig

        cfg = GPTConfig(vocab_size=64, seq_len=16, hidden=32, num_heads=2,
                        num_blocks=2, ffn_multiplier=2, dtype=torch.float32)
        exe = build_executable(cfg, PlanArtifact.from_uniform_plan(
            UniformPlan(1, 1, 1, 8, 8)), device="cpu")
        state = exe.init(0)
        ds = TokenDataset.synthetic(cfg.vocab_size, 4000, cfg.seq_len)
        losses = []
        for toks, tgts in make_input_pipeline(ds, gbs=8, device="cpu", epochs=1):
            state, loss = exe.step(state, toks, tgts)
            losses.append(loss.item())
            if len(losses) >= 6:
                break
        assert all(np.isfinite(losses))

    def test_measure_batch_generator(self):
        ds = TokenDataset.synthetic(64, 50_000, 128)
        assert measure_batch_generator_ms(ds, gbs=16, iters=5) > 0
        assert measure_batch_generator_ms(ds, gbs=16, iters=5, device="cpu") > 0


class TestPrefetchLifecycle:
    def test_feed_errors_propagate(self):
        class Exploding:
            ndim = 1

            def __len__(self):
                return 1000

            def __getitem__(self, key):
                raise RuntimeError("disk on fire")

        ds = TokenDataset.__new__(TokenDataset)
        object.__setattr__(ds, "tokens", Exploding())
        object.__setattr__(ds, "seq_len", 10)
        it = make_input_pipeline(ds, gbs=4, epochs=1, prefetch=1,
                                 shuffle_seed=None)
        with pytest.raises(RuntimeError, match="disk on fire"):
            next(it)

    def test_abandoned_iterator_stops_feed_thread(self):
        before = threading.active_count()
        ds = TokenDataset.synthetic(64, 100_000, 16)
        it = make_input_pipeline(ds, gbs=4, epochs=None, prefetch=2)
        next(it)
        it.close()  # abandoned mid-stream: the generator's finally stops the feed
        deadline = time.time() + 5
        while threading.active_count() > before and time.time() < deadline:
            time.sleep(0.05)
        assert threading.active_count() <= before
