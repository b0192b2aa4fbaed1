"""Decoder (port of `pixelsplat_tpu/model/decoder`)."""

from .decoder_splatting import DecoderOutput, DecoderSplatting, DecoderSplattingCfg

__all__ = ["DecoderOutput", "DecoderSplatting", "DecoderSplattingCfg"]
