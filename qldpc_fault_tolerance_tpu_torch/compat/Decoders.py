"""Reference ``src/Decoders.py`` API, backed by the port's decoders."""
from ..decoders import (
    BPDecoder,
    BPOSD_Decoder,
    BPOSD_Decoder_Class,
    BP_Decoder_Class,
    DecoderClass,
    FirstMinBPDecoder,
    FirstMinBP_Decoder_Class,
    GetSpaceTimeCheckMat,
    ST_BP_Decoder_Class,
    ST_BP_Decoder_syndrome,
)

__all__ = [
    "BPOSD_Decoder", "BPDecoder", "FirstMinBPDecoder", "DecoderClass",
    "BPOSD_Decoder_Class", "BP_Decoder_Class", "FirstMinBP_Decoder_Class",
    "GetSpaceTimeCheckMat", "ST_BP_Decoder_syndrome", "ST_BP_Decoder_Class",
]
