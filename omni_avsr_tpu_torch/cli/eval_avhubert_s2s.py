"""Decode a fine-tuned AV-HuBERT seq2seq model over a manifest (port of
`omni_avsr_tpu/cli/eval_avhubert_s2s.py`; reference
`av_hubert/avhubert/infer_s2s.py`): convert the fairseq checkpoint, run the
AV-HuBERT encoder and the decoder (greedy, or beam search with
`--num-beams` > 1 over one shared copy of the cross K/V per clip), report
the WER against the manifest text. Inference runs in bf16 as the JAX CLI
casts it: weights, video and stacked filterbanks in bf16, the logits in
f32. Tokens come from a fairseq dictionary file (one "<token> <count>" per
line, specials at ids 0-3).

  python -m omni_avsr_tpu_torch.cli.eval_avhubert_s2s \\
      --ckpt finetuned.pt --dict dict.wrd.txt \\
      --root-dir data/ --test-file test.csv --modality video [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import List

import torch

from ..config import AVHubertConfig, DataConfig
from ..data.datamodule import DataModule
from ..data.tokenizer import TokenizerBundle
from ..models.avhubert import avhubert_encode
from ..models.avhubert_s2s import S2SDecoderConfig, s2s_beam_decode, s2s_greedy_decode
from ..ops.augment import video_pipeline
from ..train.state import tree_map
from ..utils.metrics import WerAccumulator
from .common import check_args

INFER_DTYPE = torch.bfloat16  # the JAX CLI's inference dtype


class FairseqDictionary:
    """fairseq Dictionary: ids 0-3 = <s> <pad> </s> <unk>, then file order."""

    def __init__(self, path: str):
        self.symbols = ["<s>", "<pad>", "</s>", "<unk>"]
        with open(path) as f:
            for line in f:
                if line.strip():
                    self.symbols.append(line.split()[0])
        self.index = {s: i for i, s in enumerate(self.symbols)}
        self.bos, self.pad, self.eos, self.unk = 0, 1, 2, 3

    def decode(self, ids: List[int]) -> str:
        toks = [self.symbols[i] for i in ids if i not in (self.bos, self.pad, self.eos)]
        return " ".join(toks).replace("|", " ").strip()

    def __len__(self):
        return len(self.symbols)


def main(argv=None):
    p = argparse.ArgumentParser("eval_avhubert_s2s")
    p.add_argument("--ckpt", required=True, help="fine-tuned AVHubertSeq2Seq .pt")
    p.add_argument("--dict", required=True, help="fairseq target dictionary")
    p.add_argument("--root-dir", required=True)
    p.add_argument("--test-file", required=True)
    p.add_argument("--modality", default="video", choices=["video", "audiovisual"])
    # encoder geometry (defaults: AV-HuBERT Large)
    p.add_argument("--encoder-layers", type=int, default=24)
    p.add_argument("--encoder-dim", type=int, default=1024)
    p.add_argument("--encoder-heads", type=int, default=16)
    p.add_argument("--encoder-ffn-dim", type=int, default=4096)
    p.add_argument("--decoder-layers", type=int, default=6)
    p.add_argument("--decoder-embed-dim", type=int, default=768)
    p.add_argument("--decoder-ffn-dim", type=int, default=3072)
    p.add_argument("--decoder-heads", type=int, default=4)
    p.add_argument("--max-len", type=int, default=200)
    p.add_argument("--num-beams", type=int, default=1)
    p.add_argument("--length-penalty", type=float, default=1.0)
    p.add_argument("--device", default="cuda",
                   help="torch device; without a CUDA device the CLI stops unless given cpu")
    args = p.parse_args(argv)
    device = check_args(args)

    dictionary = FairseqDictionary(args.dict)
    enc_cfg = AVHubertConfig(
        encoder_layers=args.encoder_layers, encoder_embed_dim=args.encoder_dim,
        encoder_heads=args.encoder_heads, encoder_ffn_dim=args.encoder_ffn_dim,
    )
    dec_cfg = S2SDecoderConfig(
        vocab_size=len(dictionary), pad_id=dictionary.pad, eos_id=dictionary.eos,
        embed_dim=args.decoder_embed_dim, ffn_dim=args.decoder_ffn_dim,
        layers=args.decoder_layers, heads=args.decoder_heads,
        encoder_dim=enc_cfg.encoder_embed_dim,
    )

    from ..convert.avhubert_s2s_torch import convert_avhubert_s2s
    from ..convert.omni_ckpt import load_torch_checkpoint

    enc_params, dec_params = convert_avhubert_s2s(load_torch_checkpoint(args.ckpt), enc_cfg,
                                                  dec_cfg, dtype=INFER_DTYPE)
    enc_params = tree_map(lambda x: x.to(device), enc_params)
    dec_params = tree_map(lambda x: x.to(device), dec_params)

    tok_stub = TokenizerBundle(  # only used by the collator for the gold text
        family="llama", vocab_size=len(dictionary), bos_id=0, eos_id=2, pad_id=1,
        audio_sos_id=0, audio_eos_id=0, video_sos_id=0, video_eos_id=0,
        _encode_plain=lambda t: [], _decode=lambda ids: "",
    )
    dm = DataModule(DataConfig(root_dir=args.root_dir, test_file=args.test_file), tok_stub,
                    modality=args.modality)

    @torch.no_grad()
    def decode(video, audio_feats, video_len) -> torch.Tensor:
        # audio_feats: (B, T, 104) stacked filterbanks for --modality audiovisual
        v = video_pipeline(video, video_len, train=False)
        a = audio_feats.to(INFER_DTYPE) if audio_feats is not None else None
        enc = avhubert_encode(enc_params, enc_cfg, v.to(INFER_DTYPE), audio=a,
                              lengths=video_len)
        if args.num_beams > 1:
            return s2s_beam_decode(dec_params, dec_cfg, enc, video_len, args.max_len,
                                   args.num_beams, args.length_penalty).tokens
        return s2s_greedy_decode(dec_params, dec_cfg, enc, video_len, args.max_len).tokens

    from ..data.audio_features import batch_stacked_fbank

    acc = WerAccumulator()
    for batch in dm.test_batches():
        afeats = None
        if args.modality == "audiovisual":
            afeats = torch.from_numpy(batch_stacked_fbank(
                batch["audio"], batch["audio_len"], batch["video"].shape[1])).to(device)
        ids = decode(torch.from_numpy(batch["video"]).to(device), afeats,
                     torch.from_numpy(batch["video_len"]).to(device)).tolist()
        for ref, toks in zip(batch["gold_text"], ids):
            if dictionary.eos in toks:
                toks = toks[: toks.index(dictionary.eos)]
            hyp = dictionary.decode(toks)
            acc.update(ref, hyp)
            print(f"GOLD: {ref}\nHYP : {hyp}")
    print(f"WER: {acc.wer:.4f} ({acc.total_edit_distance}/{acc.total_length})")


if __name__ == "__main__":
    main()
