# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: polykey_v2.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import struct_pb2 as google_dot_protobuf_dot_struct__pb2
from . import common_v2_pb2 as common__v2__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x10polykey_v2.proto\x12\npolykey.v2\x1a\x1cgoogle/protobuf/struct.proto\x1a\x0f\x63ommon_v2.proto\"\xa1\x01\n\x12\x45xecuteToolRequest\x12\x11\n\ttool_name\x18\x01 \x01(\t\x12+\n\nparameters\x18\x02 \x01(\x0b\x32\x17.google.protobuf.Struct\x12\x16\n\tsecret_id\x18\x03 \x01(\tH\x00\x88\x01\x01\x12%\n\x08metadata\x18\x04 \x01(\x0b\x32\x13.common.v2.MetadataB\x0c\n\n_secret_id\"\xb5\x01\n\x13\x45xecuteToolResponse\x12!\n\x06status\x18\x01 \x01(\x0b\x32\x11.common.v2.Status\x12\x17\n\rstring_output\x18\x02 \x01(\tH\x00\x12\x30\n\rstruct_output\x18\x03 \x01(\x0b\x32\x17.google.protobuf.StructH\x00\x12&\n\x0b\x66ile_output\x18\x04 \x01(\x0b\x32\x0f.common.v2.FileH\x00\x42\x08\n\x06output\"{\n\x16\x45xecuteToolStreamChunk\x12\r\n\x05\x64\x65lta\x18\x01 \x01(\t\x12\r\n\x05\x66inal\x18\x02 \x01(\x08\x12!\n\x06status\x18\x03 \x01(\x0b\x32\x11.common.v2.Status\x12 \n\x05usage\x18\x04 \x01(\x0b\x32\x11.polykey.v2.Usage\"b\n\x05Usage\x12\x15\n\rprompt_tokens\x18\x01 \x01(\x05\x12\x19\n\x11\x63ompletion_tokens\x18\x02 \x01(\x05\x12\x0f\n\x07ttft_ms\x18\x03 \x01(\x01\x12\x16\n\x0etokens_per_sec\x18\x04 \x01(\x01\x32\xbb\x01\n\x0ePolykeyService\x12N\n\x0b\x45xecuteTool\x12\x1e.polykey.v2.ExecuteToolRequest\x1a\x1f.polykey.v2.ExecuteToolResponse\x12Y\n\x11\x45xecuteToolStream\x12\x1e.polykey.v2.ExecuteToolRequest\x1a\".polykey.v2.ExecuteToolStreamChunk0\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'polykey_v2_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _EXECUTETOOLREQUEST._serialized_start=80
  _EXECUTETOOLREQUEST._serialized_end=241
  _EXECUTETOOLRESPONSE._serialized_start=244
  _EXECUTETOOLRESPONSE._serialized_end=425
  _EXECUTETOOLSTREAMCHUNK._serialized_start=427
  _EXECUTETOOLSTREAMCHUNK._serialized_end=550
  _USAGE._serialized_start=552
  _USAGE._serialized_end=650
  _POLYKEYSERVICE._serialized_start=653
  _POLYKEYSERVICE._serialized_end=840
# @@protoc_insertion_point(module_scope)
