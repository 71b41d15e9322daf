# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: tpuserve.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0etpuserve.proto\x12\x08tpuserve\"\x0f\n\rHealthRequest\".\n\x0eHealthResponse\x12\x0e\n\x06status\x18\x01 \x01(\t\x12\x0c\n\x04time\x18\x02 \x01(\x03\"\x13\n\x11ListModelsRequest\"M\n\nModelEntry\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\t\x12\x11\n\tis_loaded\x18\x03 \x01(\x08\x12\r\n\x05state\x18\x04 \x01(\t\"S\n\x12ListModelsResponse\x12\x17\n\x0frepository_path\x18\x01 \x01(\t\x12$\n\x06models\x18\x02 \x03(\x0b\x32\x14.tpuserve.ModelEntry\"-\n\x0cModelRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\t\"\x96\x01\n\x13ModelStatusResponse\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\t\x12\x11\n\tis_loaded\x18\x03 \x01(\x08\x12\r\n\x05state\x18\x04 \x01(\t\x12\x1a\n\x12\x61vailable_versions\x18\x05 \x03(\t\x12\x13\n\x0b\x63onfig_json\x18\x06 \x01(\t\x12\r\n\x05\x65rror\x18\x07 \x01(\t\"E\n\x13ModelActionResponse\x12\x0f\n\x07message\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x0f\n\x07version\x18\x03 \x01(\t\"p\n\x06Tensor\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tdata_type\x18\x02 \x01(\t\x12\r\n\x05shape\x18\x03 \x03(\x03\x12\x12\n\nfloat_data\x18\x04 \x03(\x02\x12\x10\n\x08int_data\x18\x05 \x03(\x03\x12\x10\n\x08raw_data\x18\x06 \x01(\x0c\"O\n\x0cInferRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\t\x12 \n\x06inputs\x18\x03 \x03(\x0b\x32\x10.tpuserve.Tensor\"C\n\x0e\x43lassification\x12\r\n\x05index\x18\x01 \x01(\x05\x12\x13\n\x0bprobability\x18\x02 \x01(\x02\x12\r\n\x05label\x18\x03 \x01(\t\"b\n\x0bInferOutput\x12 \n\x06tensor\x18\x01 \x01(\x0b\x32\x10.tpuserve.Tensor\x12\x31\n\x0f\x63lassifications\x18\x02 \x03(\x0b\x32\x18.tpuserve.Classification\"b\n\rInferResponse\x12\x12\n\nmodel_name\x18\x01 \x01(\t\x12\x15\n\rmodel_version\x18\x02 \x01(\t\x12&\n\x07outputs\x18\x03 \x03(\x0b\x32\x15.tpuserve.InferOutput\"\xd4\x01\n\x0fGenerateRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\t\x12\x11\n\tinput_ids\x18\x03 \x03(\x03\x12\x16\n\x0emax_new_tokens\x18\x04 \x01(\x05\x12\x13\n\x0btemperature\x18\x05 \x01(\x02\x12\r\n\x05top_k\x18\x06 \x01(\x05\x12\r\n\x05top_p\x18\x07 \x01(\x02\x12\x1a\n\x12repetition_penalty\x18\x08 \x01(\x02\x12\x16\n\x0estop_token_ids\x18\t \x03(\x03\x12\x10\n\x08logprobs\x18\n \x01(\x08\"}\n\x10GenerateResponse\x12\x12\n\noutput_ids\x18\x01 \x03(\x03\x12\x15\n\rgenerated_ids\x18\x02 \x03(\x03\x12\x15\n\rnum_generated\x18\x03 \x01(\x05\x12\x15\n\rfinish_reason\x18\x04 \x01(\t\x12\x10\n\x08logprobs\x18\x05 \x03(\x02\"@\n\nTokenChunk\x12\r\n\x05token\x18\x01 \x01(\x03\x12\x0c\n\x04\x64one\x18\x02 \x01(\x08\x12\x15\n\rfinish_reason\x18\x03 \x01(\t\"\x10\n\x0eMetricsRequest\"\x1f\n\x0fMetricsResponse\x12\x0c\n\x04json\x18\x01 \x01(\t2\xe2\x04\n\x08TpuServe\x12;\n\x06Health\x12\x17.tpuserve.HealthRequest\x1a\x18.tpuserve.HealthResponse\x12G\n\nListModels\x12\x1b.tpuserve.ListModelsRequest\x1a\x1c.tpuserve.ListModelsResponse\x12\x44\n\x0bModelStatus\x12\x16.tpuserve.ModelRequest\x1a\x1d.tpuserve.ModelStatusResponse\x12\x42\n\tLoadModel\x12\x16.tpuserve.ModelRequest\x1a\x1d.tpuserve.ModelActionResponse\x12\x44\n\x0bUnloadModel\x12\x16.tpuserve.ModelRequest\x1a\x1d.tpuserve.ModelActionResponse\x12\x38\n\x05Infer\x12\x16.tpuserve.InferRequest\x1a\x17.tpuserve.InferResponse\x12\x41\n\x08Generate\x12\x19.tpuserve.GenerateRequest\x1a\x1a.tpuserve.GenerateResponse\x12\x43\n\x0eGenerateStream\x12\x19.tpuserve.GenerateRequest\x1a\x14.tpuserve.TokenChunk0\x01\x12>\n\x07Metrics\x12\x18.tpuserve.MetricsRequest\x1a\x19.tpuserve.MetricsResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'tpuserve_torch.server.tpuserve_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _HEALTHREQUEST._serialized_start=28
  _HEALTHREQUEST._serialized_end=43
  _HEALTHRESPONSE._serialized_start=45
  _HEALTHRESPONSE._serialized_end=91
  _LISTMODELSREQUEST._serialized_start=93
  _LISTMODELSREQUEST._serialized_end=112
  _MODELENTRY._serialized_start=114
  _MODELENTRY._serialized_end=191
  _LISTMODELSRESPONSE._serialized_start=193
  _LISTMODELSRESPONSE._serialized_end=276
  _MODELREQUEST._serialized_start=278
  _MODELREQUEST._serialized_end=323
  _MODELSTATUSRESPONSE._serialized_start=326
  _MODELSTATUSRESPONSE._serialized_end=476
  _MODELACTIONRESPONSE._serialized_start=478
  _MODELACTIONRESPONSE._serialized_end=547
  _TENSOR._serialized_start=549
  _TENSOR._serialized_end=661
  _INFERREQUEST._serialized_start=663
  _INFERREQUEST._serialized_end=742
  _CLASSIFICATION._serialized_start=744
  _CLASSIFICATION._serialized_end=811
  _INFEROUTPUT._serialized_start=813
  _INFEROUTPUT._serialized_end=911
  _INFERRESPONSE._serialized_start=913
  _INFERRESPONSE._serialized_end=1011
  _GENERATEREQUEST._serialized_start=1014
  _GENERATEREQUEST._serialized_end=1226
  _GENERATERESPONSE._serialized_start=1228
  _GENERATERESPONSE._serialized_end=1353
  _TOKENCHUNK._serialized_start=1355
  _TOKENCHUNK._serialized_end=1419
  _METRICSREQUEST._serialized_start=1421
  _METRICSREQUEST._serialized_end=1437
  _METRICSRESPONSE._serialized_start=1439
  _METRICSRESPONSE._serialized_end=1470
  _TPUSERVE._serialized_start=1473
  _TPUSERVE._serialized_end=2083
# @@protoc_insertion_point(module_scope)
