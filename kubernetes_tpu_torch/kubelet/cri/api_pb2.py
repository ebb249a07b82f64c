# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: api.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\tapi.proto\x12\rruntime.v1tpu\"B\n\x12PodSandboxMetadata\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tnamespace\x18\x02 \x01(\t\x12\x0b\n\x03uid\x18\x03 \x01(\t\"M\n\x0f\x43ontainerConfig\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05image\x18\x02 \x01(\t\x12\x0f\n\x07\x63ommand\x18\x03 \x03(\t\x12\x0c\n\x04\x61rgs\x18\x04 \x03(\t\"\xe2\x02\n\x10PodSandboxConfig\x12\x33\n\x08metadata\x18\x01 \x01(\x0b\x32!.runtime.v1tpu.PodSandboxMetadata\x12;\n\x06labels\x18\x02 \x03(\x0b\x32+.runtime.v1tpu.PodSandboxConfig.LabelsEntry\x12\x45\n\x0b\x61nnotations\x18\x03 \x03(\x0b\x32\x30.runtime.v1tpu.PodSandboxConfig.AnnotationsEntry\x12\x32\n\ncontainers\x18\x04 \x03(\x0b\x32\x1e.runtime.v1tpu.ContainerConfig\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"G\n\x14RunPodSandboxRequest\x12/\n\x06\x63onfig\x18\x01 \x01(\x0b\x32\x1f.runtime.v1tpu.PodSandboxConfig\";\n\x15RunPodSandboxResponse\x12\x16\n\x0epod_sandbox_id\x18\x01 \x01(\t\x12\n\n\x02ip\x18\x02 \x01(\t\"/\n\x15StopPodSandboxRequest\x12\x16\n\x0epod_sandbox_id\x18\x01 \x01(\t\"\x18\n\x16StopPodSandboxResponse\"1\n\x17RemovePodSandboxRequest\x12\x16\n\x0epod_sandbox_id\x18\x01 \x01(\t\"\x1a\n\x18RemovePodSandboxResponse\"\x88\x01\n\nPodSandbox\x12\n\n\x02id\x18\x01 \x01(\t\x12\x33\n\x08metadata\x18\x02 \x01(\x0b\x32!.runtime.v1tpu.PodSandboxMetadata\x12-\n\x05state\x18\x03 \x01(\x0e\x32\x1e.runtime.v1tpu.PodSandboxState\x12\n\n\x02ip\x18\x04 \x01(\t\"\x17\n\x15ListPodSandboxRequest\"B\n\x16ListPodSandboxResponse\x12(\n\x05items\x18\x01 \x03(\x0b\x32\x19.runtime.v1tpu.PodSandbox\"\x10\n\x0eVersionRequest\"@\n\x0fVersionResponse\x12\x14\n\x0cruntime_name\x18\x01 \x01(\t\x12\x17\n\x0fruntime_version\x18\x02 \x01(\t\"S\n\x0f\x45xecSyncRequest\x12\x16\n\x0epod_sandbox_id\x18\x01 \x01(\t\x12\x0f\n\x07\x63ommand\x18\x02 \x03(\t\x12\x17\n\x0ftimeout_seconds\x18\x03 \x01(\x03\"5\n\x10\x45xecSyncResponse\x12\x0e\n\x06stdout\x18\x01 \x01(\x0c\x12\x11\n\texit_code\x18\x02 \x01(\x05\"B\n\x14\x43ontainerLogsRequest\x12\x16\n\x0epod_sandbox_id\x18\x01 \x01(\t\x12\x12\n\ntail_lines\x18\x02 \x01(\x03\"%\n\x15\x43ontainerLogsResponse\x12\x0c\n\x04\x64\x61ta\x18\x01 \x01(\x0c\"\x1a\n\tImageSpec\x12\r\n\x05image\x18\x01 \x01(\t\";\n\x10PullImageRequest\x12\'\n\x05image\x18\x01 \x01(\x0b\x32\x18.runtime.v1tpu.ImageSpec\"&\n\x11PullImageResponse\x12\x11\n\timage_ref\x18\x01 \x01(\t\"\x13\n\x11ListImagesRequest\":\n\x05Image\x12\n\n\x02id\x18\x01 \x01(\t\x12\x11\n\trepo_tags\x18\x02 \x03(\t\x12\x12\n\nsize_bytes\x18\x03 \x01(\x04\":\n\x12ListImagesResponse\x12$\n\x06images\x18\x01 \x03(\x0b\x32\x14.runtime.v1tpu.Image\"=\n\x12ImageStatusRequest\x12\'\n\x05image\x18\x01 \x01(\x0b\x32\x18.runtime.v1tpu.ImageSpec\":\n\x13ImageStatusResponse\x12#\n\x05image\x18\x01 \x01(\x0b\x32\x14.runtime.v1tpu.Image\"=\n\x12RemoveImageRequest\x12\'\n\x05image\x18\x01 \x01(\x0b\x32\x18.runtime.v1tpu.ImageSpec\"\x15\n\x13RemoveImageResponse\"\x14\n\x12ImageFsInfoRequest\"A\n\x13ImageFsInfoResponse\x12\x12\n\nused_bytes\x18\x01 \x01(\x04\x12\x16\n\x0e\x63\x61pacity_bytes\x18\x02 \x01(\x04\"\x1e\n\x0bStatusError\x12\x0f\n\x07message\x18\x01 \x01(\t*e\n\x0fPodSandboxState\x12\x11\n\rSANDBOX_READY\x10\x00\x12\x14\n\x10SANDBOX_NOTREADY\x10\x01\x12\x15\n\x11SANDBOX_SUCCEEDED\x10\x02\x12\x12\n\x0eSANDBOX_FAILED\x10\x03\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'api_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _PODSANDBOXCONFIG_LABELSENTRY._options = None
  _PODSANDBOXCONFIG_LABELSENTRY._serialized_options = b'8\001'
  _PODSANDBOXCONFIG_ANNOTATIONSENTRY._options = None
  _PODSANDBOXCONFIG_ANNOTATIONSENTRY._serialized_options = b'8\001'
  _PODSANDBOXSTATE._serialized_start=1983
  _PODSANDBOXSTATE._serialized_end=2084
  _PODSANDBOXMETADATA._serialized_start=28
  _PODSANDBOXMETADATA._serialized_end=94
  _CONTAINERCONFIG._serialized_start=96
  _CONTAINERCONFIG._serialized_end=173
  _PODSANDBOXCONFIG._serialized_start=176
  _PODSANDBOXCONFIG._serialized_end=530
  _PODSANDBOXCONFIG_LABELSENTRY._serialized_start=433
  _PODSANDBOXCONFIG_LABELSENTRY._serialized_end=478
  _PODSANDBOXCONFIG_ANNOTATIONSENTRY._serialized_start=480
  _PODSANDBOXCONFIG_ANNOTATIONSENTRY._serialized_end=530
  _RUNPODSANDBOXREQUEST._serialized_start=532
  _RUNPODSANDBOXREQUEST._serialized_end=603
  _RUNPODSANDBOXRESPONSE._serialized_start=605
  _RUNPODSANDBOXRESPONSE._serialized_end=664
  _STOPPODSANDBOXREQUEST._serialized_start=666
  _STOPPODSANDBOXREQUEST._serialized_end=713
  _STOPPODSANDBOXRESPONSE._serialized_start=715
  _STOPPODSANDBOXRESPONSE._serialized_end=739
  _REMOVEPODSANDBOXREQUEST._serialized_start=741
  _REMOVEPODSANDBOXREQUEST._serialized_end=790
  _REMOVEPODSANDBOXRESPONSE._serialized_start=792
  _REMOVEPODSANDBOXRESPONSE._serialized_end=818
  _PODSANDBOX._serialized_start=821
  _PODSANDBOX._serialized_end=957
  _LISTPODSANDBOXREQUEST._serialized_start=959
  _LISTPODSANDBOXREQUEST._serialized_end=982
  _LISTPODSANDBOXRESPONSE._serialized_start=984
  _LISTPODSANDBOXRESPONSE._serialized_end=1050
  _VERSIONREQUEST._serialized_start=1052
  _VERSIONREQUEST._serialized_end=1068
  _VERSIONRESPONSE._serialized_start=1070
  _VERSIONRESPONSE._serialized_end=1134
  _EXECSYNCREQUEST._serialized_start=1136
  _EXECSYNCREQUEST._serialized_end=1219
  _EXECSYNCRESPONSE._serialized_start=1221
  _EXECSYNCRESPONSE._serialized_end=1274
  _CONTAINERLOGSREQUEST._serialized_start=1276
  _CONTAINERLOGSREQUEST._serialized_end=1342
  _CONTAINERLOGSRESPONSE._serialized_start=1344
  _CONTAINERLOGSRESPONSE._serialized_end=1381
  _IMAGESPEC._serialized_start=1383
  _IMAGESPEC._serialized_end=1409
  _PULLIMAGEREQUEST._serialized_start=1411
  _PULLIMAGEREQUEST._serialized_end=1470
  _PULLIMAGERESPONSE._serialized_start=1472
  _PULLIMAGERESPONSE._serialized_end=1510
  _LISTIMAGESREQUEST._serialized_start=1512
  _LISTIMAGESREQUEST._serialized_end=1531
  _IMAGE._serialized_start=1533
  _IMAGE._serialized_end=1591
  _LISTIMAGESRESPONSE._serialized_start=1593
  _LISTIMAGESRESPONSE._serialized_end=1651
  _IMAGESTATUSREQUEST._serialized_start=1653
  _IMAGESTATUSREQUEST._serialized_end=1714
  _IMAGESTATUSRESPONSE._serialized_start=1716
  _IMAGESTATUSRESPONSE._serialized_end=1774
  _REMOVEIMAGEREQUEST._serialized_start=1776
  _REMOVEIMAGEREQUEST._serialized_end=1837
  _REMOVEIMAGERESPONSE._serialized_start=1839
  _REMOVEIMAGERESPONSE._serialized_end=1860
  _IMAGEFSINFOREQUEST._serialized_start=1862
  _IMAGEFSINFOREQUEST._serialized_end=1882
  _IMAGEFSINFORESPONSE._serialized_start=1884
  _IMAGEFSINFORESPONSE._serialized_end=1949
  _STATUSERROR._serialized_start=1951
  _STATUSERROR._serialized_end=1981
# @@protoc_insertion_point(module_scope)
