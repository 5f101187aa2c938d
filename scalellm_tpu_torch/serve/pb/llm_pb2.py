# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: llm.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\tllm.proto\x12\x0cscalellm_tpu\"O\n\x05Usage\x12\x15\n\rprompt_tokens\x18\x01 \x01(\x05\x12\x19\n\x11\x63ompletion_tokens\x18\x02 \x01(\x05\x12\x14\n\x0ctotal_tokens\x18\x03 \x01(\x05\"\xe8\x06\n\x0eSamplingParams\x12\x17\n\nmax_tokens\x18\x01 \x01(\rH\x00\x88\x01\x01\x12\x0e\n\x01n\x18\x02 \x01(\rH\x01\x88\x01\x01\x12\x14\n\x07\x62\x65st_of\x18\x03 \x01(\rH\x02\x88\x01\x01\x12\x11\n\x04\x65\x63ho\x18\x04 \x01(\x08H\x03\x88\x01\x01\x12\x1e\n\x11\x66requency_penalty\x18\x05 \x01(\x02H\x04\x88\x01\x01\x12\x1d\n\x10presence_penalty\x18\x06 \x01(\x02H\x05\x88\x01\x01\x12\x1f\n\x12repetition_penalty\x18\x07 \x01(\x02H\x06\x88\x01\x01\x12\x18\n\x0btemperature\x18\x08 \x01(\x02H\x07\x88\x01\x01\x12\x12\n\x05top_p\x18\t \x01(\x02H\x08\x88\x01\x01\x12\x12\n\x05top_k\x18\n \x01(\x05H\t\x88\x01\x01\x12\x15\n\x08logprobs\x18\x0b \x01(\x08H\n\x88\x01\x01\x12\x19\n\x0ctop_logprobs\x18\x0c \x01(\rH\x0b\x88\x01\x01\x12 \n\x13skip_special_tokens\x18\r \x01(\x08H\x0c\x88\x01\x01\x12\x17\n\nignore_eos\x18\x0e \x01(\x08H\r\x88\x01\x01\x12\x0c\n\x04stop\x18\x0f \x03(\t\x12\x16\n\x0estop_token_ids\x18\x10 \x03(\x05\x12\x11\n\x04seed\x18\x11 \x01(\x03H\x0e\x88\x01\x01\x12?\n\nlogit_bias\x18\x12 \x03(\x0b\x32+.scalellm_tpu.SamplingParams.LogitBiasEntry\x12\x19\n\x0cguided_regex\x18\x13 \x01(\tH\x0f\x88\x01\x01\x12\x18\n\x0bguided_json\x18\x14 \x01(\tH\x10\x88\x01\x01\x12\x15\n\rguided_choice\x18\x15 \x03(\t\x1a\x30\n\x0eLogitBiasEntry\x12\x0b\n\x03key\x18\x01 \x01(\x05\x12\r\n\x05value\x18\x02 \x01(\x02:\x02\x38\x01\x42\r\n\x0b_max_tokensB\x04\n\x02_nB\n\n\x08_best_ofB\x07\n\x05_echoB\x14\n\x12_frequency_penaltyB\x13\n\x11_presence_penaltyB\x15\n\x13_repetition_penaltyB\x0e\n\x0c_temperatureB\x08\n\x06_top_pB\x08\n\x06_top_kB\x0b\n\t_logprobsB\x0f\n\r_top_logprobsB\x16\n\x14_skip_special_tokensB\r\n\x0b_ignore_eosB\x07\n\x05_seedB\x0f\n\r_guided_regexB\x0e\n\x0c_guided_json\"?\n\x0bLogProbData\x12\r\n\x05token\x18\x01 \x01(\t\x12\x10\n\x08token_id\x18\x02 \x01(\x05\x12\x0f\n\x07logprob\x18\x03 \x01(\x02\"l\n\x07LogProb\x12\r\n\x05token\x18\x01 \x01(\t\x12\x10\n\x08token_id\x18\x02 \x01(\x05\x12\x0f\n\x07logprob\x18\x03 \x01(\x02\x12/\n\x0ctop_logprobs\x18\x04 \x03(\x0b\x32\x19.scalellm_tpu.LogProbData\"\xa6\x01\n\x11\x43ompletionRequest\x12\r\n\x05model\x18\x01 \x01(\t\x12\x0e\n\x06prompt\x18\x02 \x01(\t\x12.\n\x08sampling\x18\x03 \x01(\x0b\x32\x1c.scalellm_tpu.SamplingParams\x12\x13\n\x06stream\x18\x04 \x01(\x08H\x00\x88\x01\x01\x12\x15\n\x08priority\x18\x05 \x01(\rH\x01\x88\x01\x01\x42\t\n\x07_streamB\x0b\n\t_priority\"\x86\x01\n\x10\x43ompletionChoice\x12\r\n\x05index\x18\x01 \x01(\r\x12\x0c\n\x04text\x18\x02 \x01(\t\x12\x1a\n\rfinish_reason\x18\x03 \x01(\tH\x00\x88\x01\x01\x12\'\n\x08logprobs\x18\x04 \x03(\x0b\x32\x15.scalellm_tpu.LogProbB\x10\n\x0e_finish_reason\"\xb4\x01\n\x12\x43ompletionResponse\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0e\n\x06object\x18\x02 \x01(\t\x12\x0f\n\x07\x63reated\x18\x03 \x01(\x03\x12\r\n\x05model\x18\x04 \x01(\t\x12/\n\x07\x63hoices\x18\x05 \x03(\x0b\x32\x1e.scalellm_tpu.CompletionChoice\x12\'\n\x05usage\x18\x06 \x01(\x0b\x32\x13.scalellm_tpu.UsageH\x00\x88\x01\x01\x42\x08\n\x06_usage\"\x8a\x01\n\x0b\x43hatMessage\x12\x0c\n\x04role\x18\x01 \x01(\t\x12\x0f\n\x07\x63ontent\x18\x02 \x01(\t\x12\x1c\n\x0ftool_calls_json\x18\x03 \x01(\tH\x00\x88\x01\x01\x12\x19\n\x0ctool_call_id\x18\x04 \x01(\tH\x01\x88\x01\x01\x42\x12\n\x10_tool_calls_jsonB\x0f\n\r_tool_call_id\"\x99\x02\n\x0b\x43hatRequest\x12\r\n\x05model\x18\x01 \x01(\t\x12+\n\x08messages\x18\x02 \x03(\x0b\x32\x19.scalellm_tpu.ChatMessage\x12.\n\x08sampling\x18\x03 \x01(\x0b\x32\x1c.scalellm_tpu.SamplingParams\x12\x13\n\x06stream\x18\x04 \x01(\x08H\x00\x88\x01\x01\x12\x15\n\x08priority\x18\x05 \x01(\rH\x01\x88\x01\x01\x12\x17\n\ntools_json\x18\x06 \x01(\tH\x02\x88\x01\x01\x12\x1d\n\x10tool_choice_json\x18\x07 \x01(\tH\x03\x88\x01\x01\x42\t\n\x07_streamB\x0b\n\t_priorityB\r\n\x0b_tools_jsonB\x13\n\x11_tool_choice_json\"\x9f\x01\n\nChatChoice\x12\r\n\x05index\x18\x01 \x01(\r\x12*\n\x07message\x18\x02 \x01(\x0b\x32\x19.scalellm_tpu.ChatMessage\x12(\n\x05\x64\x65lta\x18\x03 \x01(\x0b\x32\x19.scalellm_tpu.ChatMessage\x12\x1a\n\rfinish_reason\x18\x04 \x01(\tH\x00\x88\x01\x01\x42\x10\n\x0e_finish_reason\"\xa8\x01\n\x0c\x43hatResponse\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0e\n\x06object\x18\x02 \x01(\t\x12\x0f\n\x07\x63reated\x18\x03 \x01(\x03\x12\r\n\x05model\x18\x04 \x01(\t\x12)\n\x07\x63hoices\x18\x05 \x03(\x0b\x32\x18.scalellm_tpu.ChatChoice\x12\'\n\x05usage\x18\x06 \x01(\x0b\x32\x13.scalellm_tpu.UsageH\x00\x88\x01\x01\x42\x08\n\x06_usage\"\x13\n\x11ListModelsRequest\"J\n\tModelInfo\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0e\n\x06object\x18\x02 \x01(\t\x12\x0f\n\x07\x63reated\x18\x03 \x01(\x03\x12\x10\n\x08owned_by\x18\x04 \x01(\t\"K\n\x12ListModelsResponse\x12\x0e\n\x06object\x18\x01 \x01(\t\x12%\n\x04\x64\x61ta\x18\x02 \x03(\x0b\x32\x17.scalellm_tpu.ModelInfo2]\n\nCompletion\x12O\n\x08\x43omplete\x12\x1f.scalellm_tpu.CompletionRequest\x1a .scalellm_tpu.CompletionResponse0\x01\x32K\n\x04\x43hat\x12\x43\n\x08\x43omplete\x12\x19.scalellm_tpu.ChatRequest\x1a\x1a.scalellm_tpu.ChatResponse0\x01\x32S\n\x06Models\x12I\n\x04List\x12\x1f.scalellm_tpu.ListModelsRequest\x1a .scalellm_tpu.ListModelsResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'llm_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _SAMPLINGPARAMS_LOGITBIASENTRY._options = None
  _SAMPLINGPARAMS_LOGITBIASENTRY._serialized_options = b'8\001'
  _USAGE._serialized_start=27
  _USAGE._serialized_end=106
  _SAMPLINGPARAMS._serialized_start=109
  _SAMPLINGPARAMS._serialized_end=981
  _SAMPLINGPARAMS_LOGITBIASENTRY._serialized_start=678
  _SAMPLINGPARAMS_LOGITBIASENTRY._serialized_end=726
  _LOGPROBDATA._serialized_start=983
  _LOGPROBDATA._serialized_end=1046
  _LOGPROB._serialized_start=1048
  _LOGPROB._serialized_end=1156
  _COMPLETIONREQUEST._serialized_start=1159
  _COMPLETIONREQUEST._serialized_end=1325
  _COMPLETIONCHOICE._serialized_start=1328
  _COMPLETIONCHOICE._serialized_end=1462
  _COMPLETIONRESPONSE._serialized_start=1465
  _COMPLETIONRESPONSE._serialized_end=1645
  _CHATMESSAGE._serialized_start=1648
  _CHATMESSAGE._serialized_end=1786
  _CHATREQUEST._serialized_start=1789
  _CHATREQUEST._serialized_end=2070
  _CHATCHOICE._serialized_start=2073
  _CHATCHOICE._serialized_end=2232
  _CHATRESPONSE._serialized_start=2235
  _CHATRESPONSE._serialized_end=2403
  _LISTMODELSREQUEST._serialized_start=2405
  _LISTMODELSREQUEST._serialized_end=2424
  _MODELINFO._serialized_start=2426
  _MODELINFO._serialized_end=2500
  _LISTMODELSRESPONSE._serialized_start=2502
  _LISTMODELSRESPONSE._serialized_end=2577
  _COMPLETION._serialized_start=2579
  _COMPLETION._serialized_end=2672
  _CHAT._serialized_start=2674
  _CHAT._serialized_end=2749
  _MODELS._serialized_start=2751
  _MODELS._serialized_end=2834
# @@protoc_insertion_point(module_scope)
