from .bp_decoders import (
    BP_Decoder_Class,
    BPDecoder,
    BPOSD_Decoder,
    BPOSD_Decoder_Class,
    DecoderClass,
    FirstMinBP_Decoder_Class,
    FirstMinBPDecoder,
    decode_device,
    kernel_variant,
    osd_compaction_tiers,
    state_from_jax,
)

__all__ = [
    "BPDecoder",
    "BPOSD_Decoder",
    "DecoderClass",
    "BP_Decoder_Class",
    "BPOSD_Decoder_Class",
    "FirstMinBPDecoder",
    "FirstMinBP_Decoder_Class",
    "decode_device",
    "kernel_variant",
    "osd_compaction_tiers",
    "state_from_jax",
]
