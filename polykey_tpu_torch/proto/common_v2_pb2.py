# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: common_v2.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0f\x63ommon_v2.proto\x12\tcommon.v2\"\'\n\x06Status\x12\x0c\n\x04\x63ode\x18\x01 \x01(\x05\x12\x0f\n\x07message\x18\x02 \x01(\t\"j\n\x08Metadata\x12/\n\x06\x66ields\x18\x01 \x03(\x0b\x32\x1f.common.v2.Metadata.FieldsEntry\x1a-\n\x0b\x46ieldsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"=\n\x04\x46ile\x12\x11\n\tfile_name\x18\x01 \x01(\t\x12\x11\n\tmime_type\x18\x02 \x01(\t\x12\x0f\n\x07\x63ontent\x18\x03 \x01(\x0c\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'common_v2_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _METADATA_FIELDSENTRY._options = None
  _METADATA_FIELDSENTRY._serialized_options = b'8\001'
  _STATUS._serialized_start=30
  _STATUS._serialized_end=69
  _METADATA._serialized_start=71
  _METADATA._serialized_end=177
  _METADATA_FIELDSENTRY._serialized_start=132
  _METADATA_FIELDSENTRY._serialized_end=177
  _FILE._serialized_start=179
  _FILE._serialized_end=240
# @@protoc_insertion_point(module_scope)
