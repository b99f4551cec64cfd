# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: auron_tpu_torch/ir/auron.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1e\x61uron_tpu_torch/ir/auron.proto\x12\x12\x61uron_tpu_torch.ir\"\x95\x02\n\x06\x46ieldP\x12\x0c\n\x04name\x18\x01 \x01(\t\x12,\n\x05\x64type\x18\x02 \x01(\x0e\x32\x1d.auron_tpu_torch.ir.DataTypeP\x12\x10\n\x08nullable\x18\x03 \x01(\x08\x12\x11\n\tprecision\x18\x04 \x01(\r\x12\r\n\x05scale\x18\x05 \x01(\r\x12\x14\n\x0cstring_width\x18\x06 \x01(\r\x12+\n\x04\x65lem\x18\x07 \x01(\x0e\x32\x1d.auron_tpu_torch.ir.DataTypeP\x12*\n\x03key\x18\x08 \x01(\x0e\x32\x1d.auron_tpu_torch.ir.DataTypeP\x12,\n\x08\x63hildren\x18\t \x03(\x0b\x32\x1a.auron_tpu_torch.ir.FieldP\"5\n\x07SchemaP\x12*\n\x06\x66ields\x18\x01 \x03(\x0b\x32\x1a.auron_tpu_torch.ir.FieldP\"\xf1\x06\n\x08\x45xprNode\x12\x30\n\x06\x63olumn\x18\x01 \x01(\x0b\x32\x1e.auron_tpu_torch.ir.ColumnRefEH\x00\x12/\n\x07literal\x18\x02 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.LiteralEH\x00\x12-\n\x06\x62inary\x18\x03 \x01(\x0b\x32\x1b.auron_tpu_torch.ir.BinaryEH\x00\x12+\n\x05unary\x18\x04 \x01(\x0b\x32\x1a.auron_tpu_torch.ir.UnaryEH\x00\x12)\n\x04\x63\x61st\x18\x05 \x01(\x0b\x32\x19.auron_tpu_torch.ir.CastEH\x00\x12\x32\n\tcase_when\x18\x06 \x01(\x0b\x32\x1d.auron_tpu_torch.ir.CaseWhenEH\x00\x12.\n\x07in_list\x18\x07 \x01(\x0b\x32\x1b.auron_tpu_torch.ir.InListEH\x00\x12)\n\x04like\x18\x08 \x01(\x0b\x32\x19.auron_tpu_torch.ir.LikeEH\x00\x12\x36\n\x0bstring_pred\x18\t \x01(\x0b\x32\x1f.auron_tpu_torch.ir.StringPredEH\x00\x12>\n\x0fscalar_function\x18\n \x01(\x0b\x32#.auron_tpu_torch.ir.ScalarFunctionEH\x00\x12/\n\x07nullary\x18\x0b \x01(\x0b\x32\x1c.auron_tpu_torch.ir.NullaryEH\x00\x12\x30\n\x08host_udf\x18\x0c \x01(\x0b\x32\x1c.auron_tpu_torch.ir.HostUDFEH\x00\x12\x45\n\x13\x62loom_might_contain\x18\r \x01(\x0b\x32&.auron_tpu_torch.ir.BloomMightContainEH\x00\x12\x41\n\x11get_indexed_field\x18\x0e \x01(\x0b\x32$.auron_tpu_torch.ir.GetIndexedFieldEH\x00\x12?\n\x10get_struct_field\x18\x0f \x01(\x0b\x32#.auron_tpu_torch.ir.GetStructFieldEH\x00\x12>\n\x0fscalar_subquery\x18\x10 \x01(\x0b\x32#.auron_tpu_torch.ir.ScalarSubqueryEH\x00\x42\x06\n\x04\x65xpr\"\x9a\x01\n\x0fScalarSubqueryE\x12*\n\x04plan\x18\x01 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.PlanNode\x12,\n\x05\x64type\x18\x02 \x01(\x0e\x32\x1d.auron_tpu_torch.ir.DataTypeP\x12\x11\n\tprecision\x18\x03 \x01(\r\x12\r\n\x05scale\x18\x04 \x01(\r\x12\x0b\n\x03sid\x18\x05 \x01(\r\")\n\nColumnRefE\x12\r\n\x05index\x18\x01 \x01(\x05\x12\x0c\n\x04name\x18\x02 \x01(\t\"\xa1\x01\n\x08LiteralE\x12,\n\x05\x64type\x18\x01 \x01(\x0e\x32\x1d.auron_tpu_torch.ir.DataTypeP\x12\x11\n\tprecision\x18\x02 \x01(\r\x12\r\n\x05scale\x18\x03 \x01(\r\x12\x0f\n\x07is_null\x18\x04 \x01(\x08\x12\r\n\x03i64\x18\x05 \x01(\x03H\x00\x12\r\n\x03\x66\x36\x34\x18\x06 \x01(\x01H\x00\x12\r\n\x03str\x18\x07 \x01(\tH\x00\x42\x07\n\x05value\"n\n\x07\x42inaryE\x12\n\n\x02op\x18\x01 \x01(\t\x12*\n\x04left\x18\x02 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\x12+\n\x05right\x18\x03 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\"A\n\x06UnaryE\x12\n\n\x02op\x18\x01 \x01(\t\x12+\n\x05\x63hild\x18\x02 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\"\xa4\x01\n\x05\x43\x61stE\x12+\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\x12,\n\x05\x64type\x18\x02 \x01(\x0e\x32\x1d.auron_tpu_torch.ir.DataTypeP\x12\x11\n\tprecision\x18\x03 \x01(\r\x12\r\n\x05scale\x18\x04 \x01(\r\x12\x10\n\x08try_cast\x18\x05 \x01(\x08\x12\x0c\n\x04\x61nsi\x18\x06 \x01(\x08\"\xd6\x01\n\tCaseWhenE\x12\x36\n\x08\x62ranches\x18\x01 \x03(\x0b\x32$.auron_tpu_torch.ir.CaseWhenE.Branch\x12/\n\telse_expr\x18\x02 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\x1a`\n\x06\x42ranch\x12*\n\x04when\x18\x01 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\x12*\n\x04then\x18\x02 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\"u\n\x07InListE\x12+\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\x12,\n\x06values\x18\x02 \x03(\x0b\x32\x1c.auron_tpu_torch.ir.LiteralE\x12\x0f\n\x07negated\x18\x03 \x01(\x08\"V\n\x05LikeE\x12+\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\x12\x0f\n\x07pattern\x18\x02 \x01(\t\x12\x0f\n\x07negated\x18\x03 \x01(\x08\"Y\n\x0bStringPredE\x12\x0c\n\x04kind\x18\x01 \x01(\t\x12+\n\x05\x63hild\x18\x02 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\x12\x0f\n\x07pattern\x18\x03 \x01(\t\"\xae\x01\n\x0fScalarFunctionE\x12\x0c\n\x04name\x18\x01 \x01(\t\x12*\n\x04\x61rgs\x18\x02 \x03(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\x12\x11\n\thas_dtype\x18\x03 \x01(\x08\x12,\n\x05\x64type\x18\x04 \x01(\x0e\x32\x1d.auron_tpu_torch.ir.DataTypeP\x12\x11\n\tprecision\x18\x05 \x01(\r\x12\r\n\x05scale\x18\x06 \x01(\r\"\x18\n\x08NullaryE\x12\x0c\n\x04kind\x18\x01 \x01(\t\"\x9d\x01\n\x08HostUDFE\x12\x15\n\rregistry_name\x18\x01 \x01(\t\x12*\n\x04\x61rgs\x18\x02 \x03(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\x12,\n\x05\x64type\x18\x03 \x01(\x0e\x32\x1d.auron_tpu_torch.ir.DataTypeP\x12\x11\n\tprecision\x18\x04 \x01(\r\x12\r\n\x05scale\x18\x05 \x01(\r\"q\n\x12\x42loomMightContainE\x12+\n\x05value\x18\x01 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\x12\x19\n\x11serialized_filter\x18\x02 \x01(\x0c\x12\x13\n\x0bresource_id\x18\x03 \x01(\t\"P\n\x10GetIndexedFieldE\x12+\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\x12\x0f\n\x07ordinal\x18\x02 \x01(\x03\"O\n\x0fGetStructFieldE\x12+\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\x12\x0f\n\x07ordinal\x18\x02 \x01(\x03\"`\n\nSortOrderP\x12*\n\x04\x65xpr\x18\x01 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\x12\x11\n\tascending\x18\x02 \x01(\x08\x12\x13\n\x0bnulls_first\x18\x03 \x01(\x08\"|\n\x0c\x41ggFunctionP\x12\n\n\x02\x66n\x18\x01 \x01(\t\x12)\n\x03\x61rg\x18\x02 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\x12\x10\n\x08\x64istinct\x18\x03 \x01(\x08\x12\x16\n\x0e\x65xpected_items\x18\x04 \x01(\x03\x12\x0b\n\x03\x66pp\x18\x05 \x01(\x01\"\xf3\x01\n\x0fWindowFunctionP\x12\x0c\n\x04kind\x18\x01 \x01(\t\x12\n\n\x02\x66n\x18\x02 \x01(\t\x12)\n\x03\x61rg\x18\x03 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\x12\x13\n\x06offset\x18\x04 \x01(\x03H\x00\x88\x01\x01\x12\x33\n\rdefault_value\x18\x05 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.LiteralE\x12\x15\n\x08\x66rame_lo\x18\x06 \x01(\x03H\x01\x88\x01\x01\x12\x15\n\x08\x66rame_hi\x18\x07 \x01(\x03H\x02\x88\x01\x01\x42\t\n\x07_offsetB\x0b\n\t_frame_loB\x0b\n\t_frame_hi\"\xac\x0c\n\x08PlanNode\x12;\n\x0cparquet_scan\x18\x01 \x01(\x0b\x32#.auron_tpu_torch.ir.ParquetScanNodeH\x00\x12\x33\n\x08orc_scan\x18\x02 \x01(\x0b\x32\x1f.auron_tpu_torch.ir.OrcScanNodeH\x00\x12\x39\n\x0bmemory_scan\x18\x03 \x01(\x0b\x32\".auron_tpu_torch.ir.MemoryScanNodeH\x00\x12\x37\n\nipc_reader\x18\x04 \x01(\x0b\x32!.auron_tpu_torch.ir.IpcReaderNodeH\x00\x12\x30\n\x06\x66ilter\x18\x05 \x01(\x0b\x32\x1e.auron_tpu_torch.ir.FilterNodeH\x00\x12\x32\n\x07project\x18\x06 \x01(\x0b\x32\x1f.auron_tpu_torch.ir.ProjectNodeH\x00\x12*\n\x03\x61gg\x18\x07 \x01(\x0b\x32\x1b.auron_tpu_torch.ir.AggNodeH\x00\x12,\n\x04sort\x18\x08 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.SortNodeH\x00\x12.\n\x05limit\x18\t \x01(\x0b\x32\x1d.auron_tpu_torch.ir.LimitNodeH\x00\x12.\n\x05union\x18\n \x01(\x0b\x32\x1d.auron_tpu_torch.ir.UnionNodeH\x00\x12\x35\n\thash_join\x18\x0b \x01(\x0b\x32 .auron_tpu_torch.ir.HashJoinNodeH\x00\x12@\n\x0fsort_merge_join\x18\x0c \x01(\x0b\x32%.auron_tpu_torch.ir.SortMergeJoinNodeH\x00\x12?\n\x0e\x62roadcast_join\x18\r \x01(\x0b\x32%.auron_tpu_torch.ir.BroadcastJoinNodeH\x00\x12?\n\x0eshuffle_writer\x18\x0e \x01(\x0b\x32%.auron_tpu_torch.ir.ShuffleWriterNodeH\x00\x12G\n\x12\x62roadcast_exchange\x18\x0f \x01(\x0b\x32).auron_tpu_torch.ir.BroadcastExchangeNodeH\x00\x12\x30\n\x06window\x18\x10 \x01(\x0b\x32\x1e.auron_tpu_torch.ir.WindowNodeH\x00\x12\x30\n\x06\x65xpand\x18\x11 \x01(\x0b\x32\x1e.auron_tpu_torch.ir.ExpandNodeH\x00\x12\x34\n\x08generate\x18\x12 \x01(\x0b\x32 .auron_tpu_torch.ir.GenerateNodeH\x00\x12\x43\n\x10\x63oalesce_batches\x18\x13 \x01(\x0b\x32\'.auron_tpu_torch.ir.CoalesceBatchesNodeH\x00\x12?\n\x0erename_columns\x18\x14 \x01(\x0b\x32%.auron_tpu_torch.ir.RenameColumnsNodeH\x00\x12\x43\n\x10\x65mpty_partitions\x18\x15 \x01(\x0b\x32\'.auron_tpu_torch.ir.EmptyPartitionsNodeH\x00\x12;\n\x0cparquet_sink\x18\x16 \x01(\x0b\x32#.auron_tpu_torch.ir.ParquetSinkNodeH\x00\x12\x33\n\x08orc_sink\x18\x17 \x01(\x0b\x32\x1f.auron_tpu_torch.ir.OrcSinkNodeH\x00\x12.\n\x05\x64\x65\x62ug\x18\x18 \x01(\x0b\x32\x1d.auron_tpu_torch.ir.DebugNodeH\x00\x12\x37\n\nkafka_scan\x18\x19 \x01(\x0b\x32!.auron_tpu_torch.ir.KafkaScanNodeH\x00\x12\x42\n\x10rss_shuffle_read\x18\x1a \x01(\x0b\x32&.auron_tpu_torch.ir.RssShuffleReadNodeH\x00\x12J\n\x14streaming_window_agg\x18\x1b \x01(\x0b\x32*.auron_tpu_torch.ir.StreamingWindowAggNodeH\x00\x42\x06\n\x04node\"\xa4\x01\n\x0fParquetScanNode\x12\r\n\x05\x66iles\x18\x01 \x03(\t\x12+\n\x06schema\x18\x02 \x01(\x0b\x32\x1b.auron_tpu_torch.ir.SchemaP\x12\x0f\n\x07\x63olumns\x18\x03 \x03(\t\x12\x30\n\npredicates\x18\x04 \x03(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\x12\x12\n\nbatch_rows\x18\x05 \x01(\r\"n\n\x0bOrcScanNode\x12\r\n\x05\x66iles\x18\x01 \x03(\t\x12+\n\x06schema\x18\x02 \x01(\x0b\x32\x1b.auron_tpu_torch.ir.SchemaP\x12\x0f\n\x07\x63olumns\x18\x03 \x03(\t\x12\x12\n\nbatch_rows\x18\x04 \x01(\r\"8\n\x0eMemoryScanNode\x12\x12\n\ntable_name\x18\x01 \x01(\t\x12\x12\n\nbatch_rows\x18\x02 \x01(\r\"Q\n\rIpcReaderNode\x12\x13\n\x0bresource_id\x18\x01 \x01(\t\x12+\n\x06schema\x18\x02 \x01(\x0b\x32\x1b.auron_tpu_torch.ir.SchemaP\"k\n\nFilterNode\x12+\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.PlanNode\x12\x30\n\npredicates\x18\x02 \x03(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\"v\n\x0bProjectNode\x12+\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.PlanNode\x12+\n\x05\x65xprs\x18\x02 \x03(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\x12\r\n\x05names\x18\x03 \x03(\t\"\xcf\x01\n\x07\x41ggNode\x12+\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.PlanNode\x12\x31\n\x0bgroup_exprs\x18\x02 \x03(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\x12.\n\x04\x61ggs\x18\x03 \x03(\x0b\x32 .auron_tpu_torch.ir.AggFunctionP\x12\x0c\n\x04mode\x18\x04 \x01(\t\x12\x13\n\x0bgroup_names\x18\x05 \x03(\t\x12\x11\n\tagg_names\x18\x06 \x03(\t\"{\n\x08SortNode\x12+\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.PlanNode\x12\x33\n\x0bsort_orders\x18\x02 \x03(\x0b\x32\x1e.auron_tpu_torch.ir.SortOrderP\x12\r\n\x05\x66\x65tch\x18\x03 \x01(\x03\"G\n\tLimitNode\x12+\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.PlanNode\x12\r\n\x05limit\x18\x02 \x01(\x03\";\n\tUnionNode\x12.\n\x08\x63hildren\x18\x01 \x03(\x0b\x32\x1c.auron_tpu_torch.ir.PlanNode\"\xdf\x01\n\x0cHashJoinNode\x12+\n\x05probe\x18\x01 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.PlanNode\x12+\n\x05\x62uild\x18\x02 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.PlanNode\x12\x30\n\nprobe_keys\x18\x03 \x03(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\x12\x30\n\nbuild_keys\x18\x04 \x03(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\x12\x11\n\tjoin_type\x18\x05 \x01(\t\"\xe4\x01\n\x11SortMergeJoinNode\x12+\n\x05probe\x18\x01 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.PlanNode\x12+\n\x05\x62uild\x18\x02 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.PlanNode\x12\x30\n\nprobe_keys\x18\x03 \x03(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\x12\x30\n\nbuild_keys\x18\x04 \x03(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\x12\x11\n\tjoin_type\x18\x05 \x01(\t\"\x85\x02\n\x11\x42roadcastJoinNode\x12+\n\x05probe\x18\x01 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.PlanNode\x12\x19\n\x11\x62uild_resource_id\x18\x02 \x01(\t\x12\x31\n\x0c\x62uild_schema\x18\x03 \x01(\x0b\x32\x1b.auron_tpu_torch.ir.SchemaP\x12\x30\n\nprobe_keys\x18\x04 \x03(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\x12\x30\n\nbuild_keys\x18\x05 \x03(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\x12\x11\n\tjoin_type\x18\x06 \x01(\t\"\x9c\x01\n\rPartitioningP\x12\x0c\n\x04kind\x18\x01 \x01(\t\x12\x16\n\x0enum_partitions\x18\x02 \x01(\r\x12/\n\thash_keys\x18\x03 \x03(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\x12\x34\n\x0crange_orders\x18\x04 \x03(\x0b\x32\x1e.auron_tpu_torch.ir.SortOrderP\"\xd5\x01\n\x11ShuffleWriterNode\x12+\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.PlanNode\x12\x37\n\x0cpartitioning\x18\x02 \x01(\x0b\x32!.auron_tpu_torch.ir.PartitioningP\x12\x1a\n\x12output_resource_id\x18\x03 \x01(\t\x12\x18\n\x10input_partitions\x18\x04 \x01(\r\x12\x10\n\x08rss_root\x18\x05 \x01(\t\x12\x12\n\nshuffle_id\x18\x06 \x01(\r\"\x7f\n\x12RssShuffleReadNode\x12\x10\n\x08rss_root\x18\x01 \x01(\t\x12\x12\n\nshuffle_id\x18\x02 \x01(\r\x12+\n\x06schema\x18\x03 \x01(\x0b\x32\x1b.auron_tpu_torch.ir.SchemaP\x12\x16\n\x0enum_partitions\x18\x04 \x01(\r\"z\n\x15\x42roadcastExchangeNode\x12+\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.PlanNode\x12\x1a\n\x12output_resource_id\x18\x02 \x01(\t\x12\x18\n\x10input_partitions\x18\x03 \x01(\r\"\x82\x02\n\nWindowNode\x12+\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.PlanNode\x12\x32\n\x0cpartition_by\x18\x02 \x03(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\x12\x30\n\x08order_by\x18\x03 \x03(\x0b\x32\x1e.auron_tpu_torch.ir.SortOrderP\x12\x36\n\tfunctions\x18\x04 \x03(\x0b\x32#.auron_tpu_torch.ir.WindowFunctionP\x12\x14\n\x0coutput_names\x18\x05 \x03(\t\x12\x13\n\x0bgroup_limit\x18\x06 \x01(\x03\"\xc3\x01\n\nExpandNode\x12+\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.PlanNode\x12>\n\x0bprojections\x18\x02 \x03(\x0b\x32).auron_tpu_torch.ir.ExpandNode.Projection\x12\r\n\x05names\x18\x03 \x03(\t\x1a\x39\n\nProjection\x12+\n\x05\x65xprs\x18\x01 \x03(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\"\xef\x01\n\x0cGenerateNode\x12+\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.PlanNode\x12\x0c\n\x04kind\x18\x02 \x01(\t\x12/\n\tgenerator\x18\x03 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\x12\x13\n\x0bjson_fields\x18\x04 \x03(\t\x12\x1a\n\x12udtf_registry_name\x18\x05 \x01(\t\x12\x1d\n\x15required_child_output\x18\x06 \x03(\x05\x12\r\n\x05outer\x18\x07 \x01(\x08\x12\x14\n\x0coutput_names\x18\x08 \x03(\t\"W\n\x13\x43oalesceBatchesNode\x12+\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.PlanNode\x12\x13\n\x0btarget_rows\x18\x02 \x01(\r\"O\n\x11RenameColumnsNode\x12+\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.PlanNode\x12\r\n\x05names\x18\x02 \x03(\t\"Z\n\x13\x45mptyPartitionsNode\x12+\n\x06schema\x18\x01 \x01(\x0b\x32\x1b.auron_tpu_torch.ir.SchemaP\x12\x16\n\x0enum_partitions\x18\x02 \x01(\r\"w\n\x0fParquetSinkNode\x12+\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.PlanNode\x12\x0c\n\x04path\x18\x02 \x01(\t\x12\x14\n\x0cpartition_by\x18\x03 \x03(\t\x12\x13\n\x0b\x63ompression\x18\x04 \x01(\t\"]\n\x0bOrcSinkNode\x12+\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.PlanNode\x12\x0c\n\x04path\x18\x02 \x01(\t\x12\x13\n\x0b\x63ompression\x18\x03 \x01(\t\"G\n\tDebugNode\x12+\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.PlanNode\x12\r\n\x05label\x18\x02 \x01(\t\"\x95\x01\n\rKafkaScanNode\x12\r\n\x05topic\x18\x01 \x01(\t\x12\x11\n\tbootstrap\x18\x02 \x01(\t\x12+\n\x06schema\x18\x03 \x01(\x0b\x32\x1b.auron_tpu_torch.ir.SchemaP\x12\x0e\n\x06\x66ormat\x18\x04 \x01(\t\x12\x13\n\x0bmax_batches\x18\x05 \x01(\r\x12\x10\n\x08group_id\x18\x06 \x01(\t\"\x8b\x02\n\x16StreamingWindowAggNode\x12+\n\x05\x63hild\x18\x01 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.PlanNode\x12\x10\n\x08time_col\x18\x02 \x01(\r\x12\x11\n\twindow_us\x18\x03 \x01(\x03\x12\x14\n\x0cooo_bound_us\x18\x04 \x01(\x03\x12\x31\n\x0bgroup_exprs\x18\x05 \x03(\x0b\x32\x1c.auron_tpu_torch.ir.ExprNode\x12.\n\x04\x61ggs\x18\x06 \x03(\x0b\x32 .auron_tpu_torch.ir.AggFunctionP\x12\x13\n\x0bgroup_names\x18\x07 \x03(\t\x12\x11\n\tagg_names\x18\x08 \x03(\t\"\x8d\x01\n\x0eTaskDefinition\x12\x10\n\x08stage_id\x18\x01 \x01(\x05\x12\x14\n\x0cpartition_id\x18\x02 \x01(\x05\x12\x0f\n\x07task_id\x18\x03 \x01(\x03\x12\x16\n\x0enum_partitions\x18\x04 \x01(\x05\x12*\n\x04plan\x18\x05 \x01(\x0b\x32\x1c.auron_tpu_torch.ir.PlanNode*\xe7\x01\n\tDataTypeP\x12\x0b\n\x07\x44T_NULL\x10\x00\x12\x0b\n\x07\x44T_BOOL\x10\x01\x12\x0b\n\x07\x44T_INT8\x10\x02\x12\x0c\n\x08\x44T_INT16\x10\x03\x12\x0c\n\x08\x44T_INT32\x10\x04\x12\x0c\n\x08\x44T_INT64\x10\x05\x12\x0e\n\nDT_FLOAT32\x10\x06\x12\x0e\n\nDT_FLOAT64\x10\x07\x12\r\n\tDT_DATE32\x10\x08\x12\x13\n\x0f\x44T_TIMESTAMP_US\x10\t\x12\x0e\n\nDT_DECIMAL\x10\n\x12\r\n\tDT_STRING\x10\x0b\x12\x0b\n\x07\x44T_LIST\x10\x0c\x12\n\n\x06\x44T_MAP\x10\r\x12\r\n\tDT_STRUCT\x10\x0e\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'auron_tpu_torch.ir.auron_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _DATATYPEP._serialized_start=9478
  _DATATYPEP._serialized_end=9709
  _FIELDP._serialized_start=55
  _FIELDP._serialized_end=332
  _SCHEMAP._serialized_start=334
  _SCHEMAP._serialized_end=387
  _EXPRNODE._serialized_start=390
  _EXPRNODE._serialized_end=1271
  _SCALARSUBQUERYE._serialized_start=1274
  _SCALARSUBQUERYE._serialized_end=1428
  _COLUMNREFE._serialized_start=1430
  _COLUMNREFE._serialized_end=1471
  _LITERALE._serialized_start=1474
  _LITERALE._serialized_end=1635
  _BINARYE._serialized_start=1637
  _BINARYE._serialized_end=1747
  _UNARYE._serialized_start=1749
  _UNARYE._serialized_end=1814
  _CASTE._serialized_start=1817
  _CASTE._serialized_end=1981
  _CASEWHENE._serialized_start=1984
  _CASEWHENE._serialized_end=2198
  _CASEWHENE_BRANCH._serialized_start=2102
  _CASEWHENE_BRANCH._serialized_end=2198
  _INLISTE._serialized_start=2200
  _INLISTE._serialized_end=2317
  _LIKEE._serialized_start=2319
  _LIKEE._serialized_end=2405
  _STRINGPREDE._serialized_start=2407
  _STRINGPREDE._serialized_end=2496
  _SCALARFUNCTIONE._serialized_start=2499
  _SCALARFUNCTIONE._serialized_end=2673
  _NULLARYE._serialized_start=2675
  _NULLARYE._serialized_end=2699
  _HOSTUDFE._serialized_start=2702
  _HOSTUDFE._serialized_end=2859
  _BLOOMMIGHTCONTAINE._serialized_start=2861
  _BLOOMMIGHTCONTAINE._serialized_end=2974
  _GETINDEXEDFIELDE._serialized_start=2976
  _GETINDEXEDFIELDE._serialized_end=3056
  _GETSTRUCTFIELDE._serialized_start=3058
  _GETSTRUCTFIELDE._serialized_end=3137
  _SORTORDERP._serialized_start=3139
  _SORTORDERP._serialized_end=3235
  _AGGFUNCTIONP._serialized_start=3237
  _AGGFUNCTIONP._serialized_end=3361
  _WINDOWFUNCTIONP._serialized_start=3364
  _WINDOWFUNCTIONP._serialized_end=3607
  _PLANNODE._serialized_start=3610
  _PLANNODE._serialized_end=5190
  _PARQUETSCANNODE._serialized_start=5193
  _PARQUETSCANNODE._serialized_end=5357
  _ORCSCANNODE._serialized_start=5359
  _ORCSCANNODE._serialized_end=5469
  _MEMORYSCANNODE._serialized_start=5471
  _MEMORYSCANNODE._serialized_end=5527
  _IPCREADERNODE._serialized_start=5529
  _IPCREADERNODE._serialized_end=5610
  _FILTERNODE._serialized_start=5612
  _FILTERNODE._serialized_end=5719
  _PROJECTNODE._serialized_start=5721
  _PROJECTNODE._serialized_end=5839
  _AGGNODE._serialized_start=5842
  _AGGNODE._serialized_end=6049
  _SORTNODE._serialized_start=6051
  _SORTNODE._serialized_end=6174
  _LIMITNODE._serialized_start=6176
  _LIMITNODE._serialized_end=6247
  _UNIONNODE._serialized_start=6249
  _UNIONNODE._serialized_end=6308
  _HASHJOINNODE._serialized_start=6311
  _HASHJOINNODE._serialized_end=6534
  _SORTMERGEJOINNODE._serialized_start=6537
  _SORTMERGEJOINNODE._serialized_end=6765
  _BROADCASTJOINNODE._serialized_start=6768
  _BROADCASTJOINNODE._serialized_end=7029
  _PARTITIONINGP._serialized_start=7032
  _PARTITIONINGP._serialized_end=7188
  _SHUFFLEWRITERNODE._serialized_start=7191
  _SHUFFLEWRITERNODE._serialized_end=7404
  _RSSSHUFFLEREADNODE._serialized_start=7406
  _RSSSHUFFLEREADNODE._serialized_end=7533
  _BROADCASTEXCHANGENODE._serialized_start=7535
  _BROADCASTEXCHANGENODE._serialized_end=7657
  _WINDOWNODE._serialized_start=7660
  _WINDOWNODE._serialized_end=7918
  _EXPANDNODE._serialized_start=7921
  _EXPANDNODE._serialized_end=8116
  _EXPANDNODE_PROJECTION._serialized_start=8059
  _EXPANDNODE_PROJECTION._serialized_end=8116
  _GENERATENODE._serialized_start=8119
  _GENERATENODE._serialized_end=8358
  _COALESCEBATCHESNODE._serialized_start=8360
  _COALESCEBATCHESNODE._serialized_end=8447
  _RENAMECOLUMNSNODE._serialized_start=8449
  _RENAMECOLUMNSNODE._serialized_end=8528
  _EMPTYPARTITIONSNODE._serialized_start=8530
  _EMPTYPARTITIONSNODE._serialized_end=8620
  _PARQUETSINKNODE._serialized_start=8622
  _PARQUETSINKNODE._serialized_end=8741
  _ORCSINKNODE._serialized_start=8743
  _ORCSINKNODE._serialized_end=8836
  _DEBUGNODE._serialized_start=8838
  _DEBUGNODE._serialized_end=8909
  _KAFKASCANNODE._serialized_start=8912
  _KAFKASCANNODE._serialized_end=9061
  _STREAMINGWINDOWAGGNODE._serialized_start=9064
  _STREAMINGWINDOWAGGNODE._serialized_end=9331
  _TASKDEFINITION._serialized_start=9334
  _TASKDEFINITION._serialized_end=9475
# @@protoc_insertion_point(module_scope)
