"""Fine-tune AV-HuBERT with a CTC or seq2seq head (port of
`omni_avsr_tpu/cli/train_avhubert_s2s.py`; the original AV-HuBERT
recipes, `av_hubert/avhubert/hubert_asr.py` and fairseq's trainer).

Character targets come from the manifest transcripts (fairseq's letter
dictionary: the words' letters and a '|' after each word). The step is the
JAX CLI's: the fine-tune video pipeline in train mode under a threefry key
(`fold_in(PRNGKey(seed), step)`, bit-equal draws), the encoder without
dropout (the JAX step passes it no key), teacher forcing from
[eos] + targets[:-1] with label-smoothed CE for `--head s2s`, CTC with the
blank at <s> for `--head ctc`; then clip 10 and AdamW (b2 0.98, weight
decay 0.1) on `warmup_cosine_schedule(lr, 0, epochs, 100)`.
`--freeze-encoder` gives the encoder no grads and leaves it out of the
weight decay (adamw's mask), so a frozen step leaves it bit-equal. The
masters are f32; on the card the step computes in bf16 (the flash kernels
B3/B4 take bf16 inputs), on the CPU in f32. At the end, a greedy WER pass
over the test manifest (s2s head).

  python -m omni_avsr_tpu_torch.cli.train_avhubert_s2s --synthetic 4 \\
      --head s2s --max-epochs 1 --exp-dir /tmp/s2s_smoke [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import AVHubertConfig, TrainConfig
from ..data.tokenizer import TokenizerBundle
from ..models.avhubert import avhubert_encode
from ..models.avhubert_s2s import (
    S2SDecoderConfig,
    ctc_loss,
    s2s_cross_entropy,
    s2s_decoder_forward,
    s2s_greedy_decode,
)
from ..models.common import Params
from ..ops.augment import video_pipeline
from ..train.optim import AdamW
from ..train.state import master_weights, tree_leaves, tree_map
from ..utils import prng
from ..utils.metrics import WerAccumulator
from .common import check_args, read_numerics, str2bool


class LetterDictionary:
    """fairseq-style letter dictionary: <s> <pad> </s> <unk> then letters."""

    def __init__(self):
        letters = list("abcdefghijklmnopqrstuvwxyz'") + ["|"]
        self.symbols = ["<s>", "<pad>", "</s>", "<unk>"] + letters
        self.index = {s: i for i, s in enumerate(self.symbols)}
        self.bos, self.pad, self.eos, self.unk = 0, 1, 2, 3

    def encode(self, text: str) -> List[int]:
        out = []
        for w in text.lower().split():
            for ch in w:
                out.append(self.index.get(ch, self.unk))
            out.append(self.index["|"])
        return out

    def decode(self, ids: List[int]) -> str:
        chars = [self.symbols[i] for i in ids if i not in (self.bos, self.pad, self.eos)]
        return "".join(chars).replace("|", " ").strip()

    def __len__(self):
        return len(self.symbols)


def tok_stub(d: LetterDictionary) -> TokenizerBundle:
    return TokenizerBundle(
        family="llama", vocab_size=len(d), bos_id=d.bos, eos_id=d.eos,
        pad_id=d.pad, audio_sos_id=0, audio_eos_id=0, video_sos_id=0,
        video_eos_id=0, _encode_plain=lambda t: d.encode(t),
        _decode=lambda ids: d.decode(ids),
    )


def make_targets(d: LetterDictionary, texts: List[str], T: int) -> Tuple[np.ndarray, np.ndarray]:
    """(B, T) targets: each text's first T - 1 letters and EOS, pad after;
    and their lengths."""
    rows = [d.encode(t)[: T - 1] for t in texts]
    tgt = np.full((len(rows), T), d.pad, np.int32)
    lens = np.zeros(len(rows), np.int32)
    for i, r in enumerate(rows):
        seq = r + [d.eos]
        tgt[i, : len(seq)] = seq
        lens[i] = len(seq)
    return tgt, lens


def model_configs(tiny: bool, d: LetterDictionary, decoder_layers: int = 6,
                  decoder_embed_dim: int = 768, decoder_ffn_dim: int = 3072,
                  decoder_heads: int = 4) -> Tuple[AVHubertConfig, S2SDecoderConfig]:
    """The JAX CLI's encoder and decoder configurations: AV-HuBERT Large
    without LoRA and the decoder flags, or the tiny widths."""
    if tiny:
        enc_cfg = AVHubertConfig(encoder_embed_dim=48, encoder_layers=2, encoder_heads=4,
                                 encoder_ffn_dim=96, audio_feat_dim=104, lora_rank_divisor=None)
        dec_cfg = S2SDecoderConfig(vocab_size=len(d), pad_id=d.pad, eos_id=d.eos, embed_dim=32,
                                   ffn_dim=64, layers=2, heads=4, encoder_dim=48)
        return enc_cfg, dec_cfg
    from ..config import avhubert_large

    enc_cfg = avhubert_large(use_lora=False)
    dec_cfg = S2SDecoderConfig(vocab_size=len(d), pad_id=d.pad, eos_id=d.eos,
                               embed_dim=decoder_embed_dim, ffn_dim=decoder_ffn_dim,
                               layers=decoder_layers, heads=decoder_heads,
                               encoder_dim=enc_cfg.encoder_embed_dim)
    return enc_cfg, dec_cfg


def head_loss(params: Params, enc_cfg: AVHubertConfig, dec_cfg: S2SDecoderConfig, head: str,
              video: torch.Tensor, audio_feats: Optional[torch.Tensor],
              video_len: torch.Tensor, tgt: torch.Tensor, tgt_len: torch.Tensor,
              key: torch.Tensor, blank_id: int, dtype=torch.float32,
              remat: str = "dots") -> torch.Tensor:
    """The JAX CLI's `loss_fn` on {"enc", "head"} params in `dtype`: the
    train-mode video pipeline under `key`, the encoder (video and, when
    given, the (B, T, 104) stacked filterbanks), then the head's loss."""
    v = video_pipeline(video, video_len, train=True, generator=key)
    a = audio_feats.to(dtype) if audio_feats is not None else None
    enc = avhubert_encode(params["enc"], enc_cfg, v.to(dtype), audio=a, lengths=video_len,
                          remat=remat)
    if head == "s2s":
        # teacher forcing: prev = [eos] + tgt[:-1] (fairseq's convention)
        bos = torch.full((tgt.shape[0], 1), dec_cfg.eos_id, dtype=tgt.dtype, device=tgt.device)
        prev = torch.cat([bos, tgt[:, :-1]], dim=1)
        logits = s2s_decoder_forward(params["head"], dec_cfg, prev, enc, video_len)
        return s2s_cross_entropy(logits, tgt, dec_cfg.pad_id)
    return ctc_loss(params["head"], enc, video_len, tgt, tgt_len, blank_id=blank_id)


class S2STrainer:
    """f32 masters {"enc", "head"} and their AdamW, and the step of the JAX
    CLI's `train_step` on a batch already on the device."""

    def __init__(self, enc_cfg: AVHubertConfig, dec_cfg: S2SDecoderConfig, head: str,
                 params: Params, lr: float, max_epochs: int, freeze_encoder: bool, device,
                 blank_id: int = 0, dtype: Optional[torch.dtype] = None, remat: str = "dots"):
        self.enc_cfg, self.dec_cfg, self.head = enc_cfg, dec_cfg, head
        self.device = torch.device(device)
        self.dtype = dtype or (torch.bfloat16 if self.device.type == "cuda" else torch.float32)
        self.blank_id, self.remat = blank_id, remat
        self.masters = master_weights(params, self.device)
        if freeze_encoder:
            tree_map(lambda x: x.requires_grad_(False), self.masters["enc"])
        # tree_leaves walks the keys in order: the "enc" leaves, then "head"'s
        n_enc = len(list(tree_leaves(self.masters["enc"])))
        self.leaves = list(tree_leaves(self.masters))
        self.decay = [not (freeze_encoder and i < n_enc) for i in range(len(self.leaves))]
        self.tx = AdamW(TrainConfig(lr=lr, warmup_epochs=0.0, max_epochs=max_epochs), 100)
        self.opt_state = self.tx.init(self.leaves)

    def params(self) -> Params:
        """The masters in the compute dtype (inside the autograd graph)."""
        return tree_map(lambda x: x.to(self.dtype), self.masters)

    def loss_and_grads(self, video, audio_feats, video_len, tgt, tgt_len, key):
        """(loss, grads of every master leaf: zeros for a frozen encoder and
        for a leaf the batch does not reach, e.g. `audio_proj` on video)."""
        loss = head_loss(self.params(), self.enc_cfg, self.dec_cfg, self.head, video,
                         audio_feats, video_len, tgt, tgt_len, key, self.blank_id, self.dtype,
                         self.remat)
        live = [p for p in self.leaves if p.requires_grad]
        it = iter(torch.autograd.grad(loss, live, allow_unused=True))
        grads = [next(it) if p.requires_grad else None for p in self.leaves]
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(self.leaves, grads)]

    def step(self, video, audio_feats, video_len, tgt, tgt_len, key) -> torch.Tensor:
        loss, grads = self.loss_and_grads(video, audio_feats, video_len, tgt, tgt_len, key)
        self.opt_state = self.tx.update_(self.leaves, grads, self.opt_state, self.decay)
        return loss

    @torch.no_grad()
    def greedy(self, video, audio_feats, video_len, max_new: int) -> torch.Tensor:
        """(B, max_new) greedy ids of the s2s head on the eval-mode pipeline."""
        params = self.params()
        v = video_pipeline(video, video_len, train=False)
        a = audio_feats.to(self.dtype) if audio_feats is not None else None
        enc = avhubert_encode(params["enc"], self.enc_cfg, v.to(self.dtype), audio=a,
                              lengths=video_len)
        return s2s_greedy_decode(params["head"], self.dec_cfg, enc, video_len, max_new).tokens


def init_s2s_params(args, enc_cfg: AVHubertConfig, dec_cfg: S2SDecoderConfig, n_vocab: int,
                    device) -> Dict[str, Params]:
    """Random weights from `--seed` on `device` (a torch.Generator), the
    encoder converted from `--pretrain-avhubert-path` when given."""
    from ..bridge import init_avhubert, init_ctc_head, init_s2s_decoder

    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.pretrain_avhubert_path:
        from ..convert.avhubert_torch import convert_avhubert
        from ..convert.omni_ckpt import load_torch_checkpoint

        enc = convert_avhubert(load_torch_checkpoint(args.pretrain_avhubert_path), enc_cfg,
                               dtype=torch.float32)
        enc = tree_map(lambda x: x.to(device), enc)
    else:
        enc = init_avhubert(enc_cfg, gen, device)
    head = (init_s2s_decoder(dec_cfg, gen, device) if args.head == "s2s"
            else init_ctc_head(enc_cfg.encoder_embed_dim, n_vocab, gen, device))
    return {"enc": enc, "head": head}


def main(argv=None):
    p = argparse.ArgumentParser("train_avhubert_s2s")
    p.add_argument("--exp-dir", default="./exp_s2s")
    p.add_argument("--head", default="s2s", choices=["s2s", "ctc"])
    p.add_argument("--modality", default="video", choices=["video", "audiovisual"])
    p.add_argument("--root-dir", default="")
    p.add_argument("--train-file", default="")
    p.add_argument("--test-file", default="")
    p.add_argument("--pretrain-avhubert-path", default=None)
    p.add_argument("--freeze-encoder", type=str2bool, default=False)
    p.add_argument("--decoder-layers", type=int, default=6)
    p.add_argument("--decoder-embed-dim", type=int, default=768)
    p.add_argument("--decoder-ffn-dim", type=int, default=3072)
    p.add_argument("--decoder-heads", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--max-epochs", type=int, default=1)
    p.add_argument("--max-frames", type=int, default=1000)
    p.add_argument("--max-dec-len", type=int, default=64)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--tiny", type=str2bool, default=False)
    p.add_argument("--device", default="cuda",
                   help="torch device; without a CUDA device the CLI stops unless given cpu")
    args = p.parse_args(argv)
    device = check_args(args)
    remat = read_numerics().remat

    if args.synthetic:
        from ..data.synthetic import generate_corpus

        out_dir = os.path.join(args.exp_dir, "synthetic_data")
        os.makedirs(out_dir, exist_ok=True)
        train_csv, _, test_csv = generate_corpus(out_dir, n_train=args.synthetic)
        args.root_dir, args.train_file, args.test_file = out_dir, train_csv, test_csv
        args.tiny = True

    d = LetterDictionary()
    enc_cfg, dec_cfg = model_configs(args.tiny, d, args.decoder_layers, args.decoder_embed_dim,
                                     args.decoder_ffn_dim, args.decoder_heads)
    params = init_s2s_params(args, enc_cfg, dec_cfg, len(d), device)
    trainer = S2STrainer(enc_cfg, dec_cfg, args.head, params, args.lr, args.max_epochs,
                         args.freeze_encoder, device, blank_id=d.bos, remat=remat)
    del params

    from ..data.audio_features import batch_stacked_fbank
    from ..data.batching import CollateConfig, bucket_batches, collate
    from ..data.dataset import AVDataset

    def on_device(b, T):
        afeats = (torch.from_numpy(batch_stacked_fbank(b["audio"], b["audio_len"], T)).to(device)
                  if args.modality == "audiovisual" else None)
        return (torch.from_numpy(b["video"]).to(device), afeats,
                torch.from_numpy(b["video_len"]).to(device))

    ds = AVDataset(args.root_dir, args.train_file, args.modality)
    tok = tok_stub(d)
    rng = prng.PRNGKey(args.seed)
    global_step = 0
    for epoch in range(args.max_epochs):
        t0 = time.time()
        losses = []
        for batch_idx in bucket_batches(ds.input_lengths, args.max_frames, 10, shuffle=True,
                                        seed=epoch):
            samples = [ds[i] for i in batch_idx]
            b = collate(samples, tok, CollateConfig(modality=args.modality))
            T = b["video"].shape[1]
            tgt, tgt_len = make_targets(d, [s["text"] for s in samples],
                                        min(args.max_dec_len, T))
            video, afeats, video_len = on_device(b, T)
            loss = trainer.step(video, afeats, video_len, torch.from_numpy(tgt).to(device),
                                torch.from_numpy(tgt_len).to(device),
                                prng.fold_in(rng, global_step))
            global_step += 1
            losses.append(float(loss))
        print(f"epoch {epoch}: loss={np.mean(losses):.4f} ({time.time()-t0:.1f}s)")

    # greedy WER over the test manifest (s2s head)
    if args.test_file and args.head == "s2s":
        ds_t = AVDataset(args.root_dir, args.test_file, args.modality)
        acc = WerAccumulator()
        for i in range(len(ds_t)):
            s = ds_t[i]
            b = collate([s], tok, CollateConfig(modality=args.modality, is_trainval=False))
            video, afeats, video_len = on_device(b, b["video"].shape[1])
            toks = trainer.greedy(video, afeats, video_len, args.max_dec_len)[0].tolist()
            if d.eos in toks:
                toks = toks[: toks.index(d.eos)]
            acc.update(s["text"], d.decode(toks))
        print(f"WER: {acc.wer:.4f} ({acc.total_edit_distance}/{acc.total_length})")
    return trainer


if __name__ == "__main__":
    main()
