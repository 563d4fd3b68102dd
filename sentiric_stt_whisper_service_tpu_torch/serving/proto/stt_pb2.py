# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: stt.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\tstt.proto\x12\x0fsentiric.stt.v1\"I\n\x08WordData\x12\x0c\n\x04word\x18\x01 \x01(\t\x12\r\n\x05start\x18\x02 \x01(\x01\x12\x0b\n\x03\x65nd\x18\x03 \x01(\x01\x12\x13\n\x0bprobability\x18\x04 \x01(\x02\"R\n\x18WhisperTranscribeRequest\x12\x12\n\naudio_data\x18\x01 \x01(\x0c\x12\x15\n\x08language\x18\x02 \x01(\tH\x00\x88\x01\x01\x42\x0b\n\t_language\"\x9d\x03\n\x19WhisperTranscribeResponse\x12\x15\n\rtranscription\x18\x01 \x01(\t\x12\x10\n\x08language\x18\x02 \x01(\t\x12\x1c\n\x14language_probability\x18\x03 \x01(\x02\x12\x10\n\x08\x64uration\x18\x04 \x01(\x01\x12\x14\n\x0cgender_proxy\x18\x05 \x01(\t\x12\x15\n\remotion_proxy\x18\x06 \x01(\t\x12\x0f\n\x07\x61rousal\x18\x07 \x01(\x02\x12\x0f\n\x07valence\x18\x08 \x01(\x02\x12\x12\n\npitch_mean\x18\t \x01(\x02\x12\x11\n\tpitch_std\x18\n \x01(\x02\x12\x13\n\x0b\x65nergy_mean\x18\x0b \x01(\x02\x12\x12\n\nenergy_std\x18\x0c \x01(\x02\x12\x19\n\x11spectral_centroid\x18\r \x01(\x02\x12\x1a\n\x12zero_crossing_rate\x18\x0e \x01(\x02\x12\x13\n\x0bspeaker_vec\x18\x0f \x03(\x02\x12\x12\n\nspeaker_id\x18\x10 \x01(\t\x12(\n\x05words\x18\x11 \x03(\x0b\x32\x19.sentiric.stt.v1.WordData\"5\n\x1eWhisperTranscribeStreamRequest\x12\x13\n\x0b\x61udio_chunk\x18\x01 \x01(\x0c\"\x85\x03\n\x1fWhisperTranscribeStreamResponse\x12\x15\n\rtranscription\x18\x01 \x01(\t\x12\x10\n\x08language\x18\x02 \x01(\t\x12\x10\n\x08is_final\x18\x03 \x01(\x08\x12\x14\n\x0cgender_proxy\x18\x04 \x01(\t\x12\x15\n\remotion_proxy\x18\x05 \x01(\t\x12\x0f\n\x07\x61rousal\x18\x06 \x01(\x02\x12\x0f\n\x07valence\x18\x07 \x01(\x02\x12\x12\n\npitch_mean\x18\x08 \x01(\x02\x12\x11\n\tpitch_std\x18\t \x01(\x02\x12\x13\n\x0b\x65nergy_mean\x18\n \x01(\x02\x12\x12\n\nenergy_std\x18\x0b \x01(\x02\x12\x19\n\x11spectral_centroid\x18\x0c \x01(\x02\x12\x1a\n\x12zero_crossing_rate\x18\r \x01(\x02\x12\x13\n\x0bspeaker_vec\x18\x0e \x03(\x02\x12\x12\n\nspeaker_id\x18\x0f \x01(\t\x12(\n\x05words\x18\x10 \x03(\x0b\x32\x19.sentiric.stt.v1.WordData2\x82\x02\n\x11SttWhisperService\x12j\n\x11WhisperTranscribe\x12).sentiric.stt.v1.WhisperTranscribeRequest\x1a*.sentiric.stt.v1.WhisperTranscribeResponse\x12\x80\x01\n\x17WhisperTranscribeStream\x12/.sentiric.stt.v1.WhisperTranscribeStreamRequest\x1a\x30.sentiric.stt.v1.WhisperTranscribeStreamResponse(\x01\x30\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'stt_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _WORDDATA._serialized_start=30
  _WORDDATA._serialized_end=103
  _WHISPERTRANSCRIBEREQUEST._serialized_start=105
  _WHISPERTRANSCRIBEREQUEST._serialized_end=187
  _WHISPERTRANSCRIBERESPONSE._serialized_start=190
  _WHISPERTRANSCRIBERESPONSE._serialized_end=603
  _WHISPERTRANSCRIBESTREAMREQUEST._serialized_start=605
  _WHISPERTRANSCRIBESTREAMREQUEST._serialized_end=658
  _WHISPERTRANSCRIBESTREAMRESPONSE._serialized_start=661
  _WHISPERTRANSCRIBESTREAMRESPONSE._serialized_end=1050
  _STTWHISPERSERVICE._serialized_start=1053
  _STTWHISPERSERVICE._serialized_end=1311
# @@protoc_insertion_point(module_scope)
