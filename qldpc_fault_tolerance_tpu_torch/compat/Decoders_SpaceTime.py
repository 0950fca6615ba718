"""Reference ``src/Decoders_SpaceTime.py`` API, backed by the port's decoders."""
from ..decoders import (
    BPDecoder,
    BPOSD_Decoder,
    BPOSD_Decoder_Class,
    BP_Decoder_Class,
    DecoderClass,
    FirstMinBPDecoder,
    GetSpaceTimeCheckMat,
    ST_BPOSD_Decoder_Circuit,
    ST_BPOSD_Decoder_Circuit_Class,
    ST_BP_Decoder_Circuit,
    ST_BP_Decoder_Circuit_Class,
    ST_BP_Decoder_Class,
    ST_BP_Decoder_syndrome,
)

__all__ = [
    "BPOSD_Decoder", "BPDecoder", "FirstMinBPDecoder", "DecoderClass",
    "BPOSD_Decoder_Class", "BP_Decoder_Class", "GetSpaceTimeCheckMat",
    "ST_BP_Decoder_syndrome", "ST_BP_Decoder_Class", "ST_BP_Decoder_Circuit",
    "ST_BPOSD_Decoder_Circuit", "ST_BP_Decoder_Circuit_Class",
    "ST_BPOSD_Decoder_Circuit_Class",
]
