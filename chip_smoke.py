#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its CUDA kernels against
their plain PyTorch versions.

    python3 chip_smoke.py

Phases (a phase that finds any disagreement raises at its end, after printing
every check; nothing is caught):

1. device: versions, the card's name and power limit, and the build of every
   kernel from `deep_gcns_torch_tpu_torch/csrc` (one `nvcc` per source, in
   parallel, into the git-ignored build directory);
2. kernels: K1 (plain and gathered form), K2 and K4's gather form in float32
   and bfloat16, and the fused aggregation's autograd backward, against the
   plain versions at
   the main path's shapes (ogbn-arxiv size: N=169,343, 14 random in-edges per
   node plus self-loops, C=128); K2 launched twice, bit for bit; K2's corner
   cases on a 3,000-node graph with a hub row of 5,000 edges, rows of
   D − 1, D and D + 1 edges (D = `K2_SPLIT_EDGES`) and 100 rows with no edge
   (and, for K4 in phase 14, a hub sender of 4,000 edges and 100 senders
   with none), at C=40, 64, 128 and 41, f32 and bf16 (empty rows exact 0,
   two launches bit for bit); there K2's long-row split, at the graph's
   count of split rows and with every row split, against the plain version
   and bit for bit the launch that splits none, its rows counted in
   `softmax_agg.split_rows`; and the fused Function at C=128 with the
   graph's count, forward and backward, against the plain Function and bit
   for bit the one that splits none (phase 14 repeats both with `ee`);
3. agreement: a small DeeperGCN on the card (kernels) against the same
   weights on the CPU (plain versions): logits and gradients;
4. main path, gather route: ResGEN-28 (res+, softmax_sg t=0.1, batch norm,
   one-layer MLP, dropout 0.5, bf16 compute, C=128, 40 classes, Adam 1e-2)
   trained through the app's `train_step` for one warm-up and 3 timed steps,
   then one `predict`; the launch counts must show 28 K2 launches per
   forward and 28 K4 launches (its gather form) per backward;
5. profile: a `torch.profiler` trace of one more train step, printed as
   device time by kernel and the device's busy share of the window;
6. timing: CUDA-event times of K1 (gathered form), K2 and K4's gather form
   (the backward) at the main shapes, beside their plain versions, a
   library yardstick for K1 and the least time the card could take for the
   same work (for K2 and K4 the larger of the bytes, the float32 operations
   and the accurate expf calls on the special-function units);
7. band graph: the realistic power-law community graph (N=169,343, average
   degree 15, `cluster_order` with clusters of 16,384, `attach_band` with
   window and hubs "auto"), built on the host by the native library (which
   must load), with its window, coverage, hub counts and device bytes;
8. band kernels: K3 against its plain version in float32 and bfloat16 on the
   packed [N_pad, 256] forward table and on an [N_pad, 128] table, with a
   hash edge-drop (p=0.3) in both id orders, and `band_spmm` and
   `band_softmax_agg` (softmax_sg and learn_t) forward and backward against
   the same Functions on the plain versions;
9. main path, band route: ResGEN-28 on the band graph, one warm-up, 3 timed
   steps and a `predict`; K3 must launch 56 times a step and 28 times a
   `predict`, K1 as often wherever the leftover is not empty, K2 never;
10. profile of one band-route step;
11. the same graph on the gather route (`g.replace(band=None)`): one warm-up
   and 1 step, and the card's band/gather step ratio;
12. timing of K3 in bf16 on the packed forward table, its bound and a
   `torch.sparse.mm` yardstick of the in-band adjacency;
13. cluster graph: one ogbn-proteins cluster under the reference's 10-way
   random partition, at `bench.py:221-231`'s shape (N=13,000, E=780,000
   uniform random edges, seed 0), with 8-dim edge features in both edge
   orders, a species one-hot, 8 node features and 112 binary tasks;
14. edge kernels: K2 with edge embeddings and K4 (with and without dt) in
   float32 and bfloat16 at C=40 (a RevGCN group) and C=64 (DyResGEN), and
   the fused Function with edge embeddings forward and backward
   (softmax_sg and learn_t), against the plain versions; K2 with `ee` and
   K4 (dx, dee and dt) launched twice, bit for bit; both on phase 2's
   corner graph (K4 at C=40, 64, 128 and 41, f32 and bf16, with and without
   dt: senders with no edge exact 0 in dx, dee's padding rows exact 0);
15. edge agreement: a small RevGCN and a small DyResGEN on the card against
   the same weights on the CPU: logits and every gradient;
16. main path, RevGCN at L=101 then L=1001 (80 channels, group 2, bf16)
   through `apps/ogbn_proteins_rev`'s `train_step` and `predict`: one
   warm-up, 1 timed step and a `predict` each; K2 with
   `ee` must launch 2·L·G times a step and L·G times a `predict`, K4 L·G
   times a step, K1, K3 and K2 without `ee` never; a profile of one L=101
   step; the O(1)-memory check: the peak may grow from L=101 to L=1001 by
   no more than the parameters, gradients and Adam moments of the extra
   layers (16 bytes a parameter) plus 256 MB;
17. main path, DyResGEN-112 (C=64, learned t, per-layer edge encoders,
   bf16) through `apps/ogbn_proteins`: one warm-up, 1 timed step and a
   `predict`; K2 with `ee` 112 launches a step and a `predict`, K4 112 a
   step;
18. app: `apps/ogbn_proteins_rev.main` for one epoch on synthetic
   ogbn-proteins (132,534 nodes, degree 60, 10 clusters, 14 layers, 5
   evaluation parts, bf16), with its host partition seconds;
19. timing of K2 with `ee` and K4 in bf16 at C=40 on the cluster graph,
   beside their plain versions and bounds (K2's as in phase 6), and K4
   with dt at C=64 beside its bound;
20. RevGAT graph: `bench.py:420-428`'s power-law community graph (N=169,343,
   degree 8, alpha 0.6) made symmetric, with self-loops, cluster order at
   16,384 and its band ("auto");
21. GAT kernels: K5 against its plain version, and K6 through the
   Function's backward against the Function on the plain versions, at
   RevGAT-5L's three packed widths (3x256+3, 3x128+3, 1x40+1, padded to a
   multiple of 8), in float32 and bfloat16, with and without the hash keep;
   and K5's corner cases on a 5,000-node graph (a receiver of 4,500 edges,
   40 receivers whose every edge is dropped and 100 with none: num, den and
   the padding columns exact 0), at P=776, 392, 48 and 123 (D=41, scalar
   loads), f32 and bf16, two launches bit for bit; and K6's on its mirror (a
   sender of 4,500 CSC edges, 40 senders whose every edge `keep_csc` drops
   and 100 with none: their rows and the padding columns exact 0), with and
   without `keep_csc`, at the same widths;
22. GAT agreement: a small RevGAT on the card against the same weights on
   the CPU, on the CSC route and on the band route;
23. main path, RevGAT-5L (`bench.py:119-132`: 256 hidden x 3 heads, group
   2, 128 + 40 label channels, dropout 0.75, input dropout 0.25, edge-drop
   0.3, symmetric norm, bf16, RMSprop warming up from lr 0) through
   `apps/ogbn_arxiv_dgl`'s `train_step` and `predict`, on the band route
   and on the CSC route of the same graph: one warm-up, 2 timed steps and a
   `predict` each, the launch counts (CSC: 14 K5 and 8 K6 a step, 16 K5 a
   `predict`; band: 22 K3 a step and 16 a `predict`, K1 as often where the
   leftover is not empty, no K5/K6), peaks, the CSC/band ratio, a profile
   of one step on each route;
24. app: `apps/ogbn_arxiv_dgl.main` for 6 epochs on synthetic data (20,000
   nodes, bf16);
25. timing of K5 and K6 in bf16 at the three widths with the training
   step's hash keep, beside their plain versions, their bounds and the
   bound if every row gather came from HBM;
26. dense kernels: K7 against its plain version (M bit for bit, two
   launches bit for bit), K8 and K9 directly and through the dense
   Function's backward against the Function on the plain versions, at the
   three head shapes, in f32 and bf16, with and without the hash drop, on
   the RevGAT graph's band; and K7 the same way on a 4,096-node band whose
   rows reach and pass K7's list of kept positions (up to 700 window
   positions a row, hub columns attached), done in chunks in the kernel;
   and K8 on that band's receiver rows (with and without hub columns) and
   K9 on the mirror transpose band, whose sender rows pass K9's list,
   with and without hub columns, at the three head shapes and D=41, f32
   and bf16, with and without the drop (rows with no kept position exact
   0, two launches bit for bit);
27. dense agreement: small RevGATs with destination scores and with the
   per-receiver stabilizer, and a small PyG GATConv with explicit self
   edges, on a band's dense route on the card against the CPU;
28. main path, dense route: RevGAT-5L with destination scores
   (`--use_attn_dst`) on the band: one warm-up, 3 timed steps, a `predict`
   and a profiled step; 14 K7 and 8 K8 and K9 a step, 16 K7 a `predict`, K1
   per leftover pass (14 + 2·8 a step), no K3, K5 or K6; then sender-only
   scores with `--gat_stabilizer per_receiver`: one warm-up and one step,
   and both steps over the band route's `auto` step;
29. timing of K7, K8 and K9 in bf16 at the three head shapes with the
   step's hash drop, beside their plain versions and bounds;
30. block-sparse graph: tests/test_blocksparse.py's banded graph at the TPU
   prototype's shape (N=169,343, degree 15, bandwidth 256, seed 0) and its
   tiles for A and Aᵀ, with their fill, tile counts and host build seconds;
31. K10 against its plain version: forward and transpose tiles, f32 and
   bf16, C=128, 40 and 3, directly (two launches bit for bit) and through
   `block_spmm`'s backward; receiver blocks with no edge, which must come
   out exact 0; and one (r, s) edge 300 times in a tile beside others and
   one 520 times, exact against the plain version on integer-valued x;
32. K10's drive and timing: `block_spmm` forward and backward once (2
   launches), then K10 in bf16 at C=128 beside its plain version,
   `torch.sparse.mm` of the same adjacency, K1 on the same edges and its
   bound, with K10's ratios to the three (no route of the JAX package
   calls K10), and K10 in float32 beside `torch.sparse.mm` in float32;
33. checkpoint path, arxiv: `apps/ogbn_arxiv.main` as ResGEN-28 (bf16) on
   169,343 synthetic nodes for 2 epochs with `--save_ckpt`, resumed with
   `--pretrained_model` to epoch 4, and `apps/ogbn_arxiv_test.main` on the
   checkpoint, whose accuracies must equal the training run's at the saved
   epoch (28 K2 launches);
34. checkpoint path, RevGAT: `apps/ogbn_arxiv_dgl` teacher with
   `--save_ckpt`, then `--mode student --teacher_ckpt` (20,000 nodes, 2
   epochs each);
35. checkpoint path, proteins: `apps/ogbn_proteins_rev` for one epoch with
   `--save_ckpt` (asynchronous rolling checkpoint and `ckpt_best`), then
   `apps/ogbn_proteins_test` on it (ROC-AUC within 1e-3 of the app's);
36. remat: ResGEN-28 on the main graph with `remat` and
   `checkpoint_prologue` against the same weights without them: the warm-up
   loss bit for bit and every gradient within TOL_BWD_BF16, then one timed
   step each with its peak (lower with remat) and launches (K2 2L-1 with
   remat, L without);
37. mean route: a small DeeperGCN with `aggr="mean"` on the card against the
   same weights on the CPU (logits and gradients, as phase 3), then
   ResGEN-28 with `aggr="mean"` (phase 4's model and graph otherwise)
   through the app's `train_step`: one warm-up, 2 timed steps and a
   `predict`, K1 56 launches a step (28 plain-form sums forward, 28
   gathered sums in the gather's backward) and 28 a `predict`, K2 none,
   finite losses, the step time and peak;
38. K1's corner cases on a 3,000-node graph (a receiver and a sender of
   5,000 edges each, 100 nodes with no edge, the CSC index sentinel-padded)
   at C=8, 30, 48, 128, 392 and 776, f32 and bf16, plain and gathered:
   against the plain version, rows with no edge exact 0, two launches bit
   for bit;
39. K1's timing at every shape its paths give it (`K1_PATHS`): the time,
   the device time, the bound, the time if every gathered row came from
   HBM, the plain version's time and a library time (`torch.sparse.mm` for
   the gathered form, `torch.segment_reduce` for the plain), and the
   gathered shapes without their rows of more than 64 edges;
40. OGB graphs (float32 as the JAX apps run): a 32-molecule batch
   of the ogbg-mol app's synthetic molecules (N_pad 1,024, E_pad 3,072) with
   a BondEncoder's embeddings at C=256 in both edge orders, a 16-graph
   batch of ogbg-ppa's with Linear(7, 128) edge embeddings, and ogbl-collab's
   SBM at its node count (235,868);
41. OGB kernels: K2 with `ee` and K4 with and without dt at C=256 and
   C=128, K2 and K1's gathered form at C=64 (`OGB_SHAPES`) against their
   plain versions (K4's d(ee) padding rows exact 0), two launches bit for
   bit, and the fused Function with the BondEncoder's embeddings and
   learned t at C=256 against the Function on the plain versions;
42. OGB agreement: a small model of each OGB app (ogbg-mol's AtomEncoder,
   BondEncoders, learned t, virtual node and pooling; ogbg-ppa's one-time
   edge encoder; the ogbl-collab objective with the LinkPredictor;
   ogbn-products' node-level model) on the card against the same weights on
   the CPU: outputs and every gradient;
43. the ogbg apps at full width from seed 0 (`ogb_configs`): molhiv
   DyResGEN-7 (C=256, learned t, batches of 32), molpcba ResGEN-14 with the
   virtual node and 128 NaN-masked tasks, ppa ResGEN-28 (C=128, one-time
   edge encoder, batches of 16): one warm-up and 2-3 timed batches through
   the app's `train_step`, a timed scoring pass over the test graphs,
   exact launches (K2 `ee` one a layer a forward, K4 one a layer a
   backward), finite losses, the peak, a profile of one more batch; then
   the app's `main` with
   `--save_ckpt` and its test script, whose score equals the run's best;
44. ogbl-collab at the app's defaults on its SBM (3 layers, C=64, batches
   of 8,192 edges): one warm-up and 3 timed updates, a timed Hits@50 pass
   (K2 3 a forward, K1 3 a backward), a profile of one more update, then
   `main` and the test script (the same Hits@50);
45. ogbn-products ResGEN-14 (C=128, 47 classes) on the app's SBM at
   ogbn-products' node count (2,449,029), 10 random clusters: the host
   build and partition seconds, one warm-up and 3 timed cluster steps, a
   timed `predict` of a cluster (K2 14 a forward, K1 14 a backward), a
   profile of one more cluster step, then the app's `train` for one epoch
   with `--save_ckpt` and the test script's `score` on the same data (the
   same accuracies);
46. the OGB shapes' times in float32 (`time_fn`, `device_ms`, the plain
   version's, the bound and, for K1, `torch.sparse.mm`), one `kernels` row
   each;
47. K2's message form against its plain version on phase 2's graph
   and on phase 2's K2 corner graph, f32 and bf16, C=40, 64, 128 and 256,
   messages of either sign with JAX's exact shift (rows with no edge exact
   0, two launches bit for bit), and the message-form Function forward and
   backward (softmax_sg, learned t, softmax_sum with learned y) against the
   Function on the plain version;
48. unfused agreement: phase 3's small DeeperGCN on a graph without its CSC
   (GENConv's unfused branch: a plain gather, relu + ε, K2's message form)
   on the card against the CPU;
49. the unfused main path: phase 4's ResGEN-28 (same weights) on phase 4's
   graph without its CSC: one warm-up, 2 timed steps and a `predict`, 28
   message-form launches a forward and no other kernel, its step time and
   peak beside phase 4's, a profiled step; then the message form's timing at
   that shape;
50. PPI at full width on PPI-shaped graphs from seed 0 (50 features, 121
   labels, 2,245 nodes and 61,318 directed edges on average, padded by
   `apps/ppi`'s batcher): ResMRGCN-14 x 64 in float32 (the app's defaults)
   and ResMRGCN-28 x 256 in bf16, each through the app's `train_step` for
   one warm-up and 3 timed steps, a timed `predict`, K1 2·(blocks − 1)
   times a step (the gathers' backward) and never in `predict`, finite
   losses, the peak and a profiled step; then K1's timing at PPI's shapes
   (gathered and plain, C=64 f32 and C=256 bf16, beside `index_add_` and
   `torch.segment_reduce`);
51. `apps/ppi.main --synthetic --epochs 2 --save_ckpt` and `apps/ppi_test`
   on its `ckpt_best`, whose valid micro-F1 must equal the run's best;
52. zoo agreement: a 3-block `DeepGCNStatic` of each conv (edge, mr, gat,
   gcn, gin, sage, rsage) and each block kind (res, dense, plain) on the
   card against the CPU: the logits, and each graph layer (head conv and
   blocks) on the same input, its output, input gradient and every
   parameter gradient;
53. (after phase 12, on phase 7's graph) the zoo's band routes card against
   CPU: SemiGCN, GIN, SAGE and relative SAGE through `band_sum_auto` (K3
   launched, `band_sum_ok` held), and MRConv and GENConv max/min on a
   100,000-node hub-free graph of bandwidth 64 where `band_extreme_ok`
   holds (phase 7's graph, with hubs, is refused): `band_extreme` on the
   CPU against the gather + segment max on the card, where
   `band_extreme_route` sends it; no route miss counted; then
   `band_extreme` on the card against the gather + segment max there, and
   both timed forward and backward (C=64 f32, C=256 bf16) on that graph
   and on a PPI-shaped one;
54. (after phase 18, on the proteins cluster) RevGCN with `GCNBlock` and
   with `SAGEBlock` at L=101 (80 channels, group 2) through
   `apps/ogbn_proteins_rev`'s `train_step`: one warm-up, 2 timed steps and
   a `predict` each, K1 3·L·G a step and L·G a `predict`, the peak, a
   profiled step;
55. point-cloud kernels (after phase 46): a dilated kNN (k=16, d=4) of
   random points at the S3DIS shape (B=8 × N=4,096) and its transpose (one
   point made no one's neighbour): K1's gathered form at C=64 in f32 and
   bf16 against its plain version, two launches bit for bit, that point
   exact 0; `gather_neighbors` forward (bit for bit) and backward against
   the plain index_select and autograd's scatter, K1 once a backward at
   C=64 and never at C=9;
56. kNN on the card: the exact dilated kNN at d = 1, 4 and 27 against a
   float64 recomputation (each neighbour within 1e-5 of the largest
   distance of the true rank's; self first), the approximate form's rules,
   and the kNN's times;
57. point-cloud agreement: small DenseDeepGCN, DeepGCNCls and SparseDeepGCN
   on the card against the CPU: logits on the CPU's kNN graphs replayed on
   the card, each graph layer's output and gradients on the CPU's input
   and graph, every flip of the card's own kNN named (a flip that is not a
   near tie fails);
58. main path: `apps/sem_seg_dense`'s `train_step` at its defaults
   (ResGCN-28 EdgeConv, k=16, dilation 1 + i, C=64, B=8 × N=4,096 with 9
   channels, float32, Adam 1e-3, dropout 0.3): one warm-up, 3 timed steps,
   a timed `predict`, K1 exactly 27 times a backward and never in a
   forward, the peak, a profiled step; then one bf16-compute step; then
   `apps/modelnet_cls` the same way at its defaults (ResGCN-14, k=9,
   stochastic dilation, B=32 × N=1,024, SGD): K1 13 times a backward;
59. the four point-cloud apps (`sem_seg_dense` at 14 blocks, `sem_seg_sparse`
   at 7, `modelnet_cls` and `part_sem_seg` at their defaults) for 2 epochs
   on `--synthetic` data with `--save_ckpt`, and each test or eval script,
   whose score must equal the run's best;
60. K1's timing at the point-cloud shapes (S3DIS d=1 and d=27 f32, d=1
   bf16, ModelNet f32): time, device time, plain, bound, `index_add_` (the
   `library_ms`) and `torch.sparse.mm` of the transposed selection;
61. parallel graphs (after phase 60, the parent's models freed): phase 7's
   cluster-ordered power-law graph and phase 4's gather graph, each sharded
   over 2 ranks on the host (the first with each rank's local band), with
   the halo rows a rank ships a layer; the single-process ResGEN-28's eval
   logits of both at seed 0's weights; phase 65's clusters and the
   sequential reference step;
62. spatial ResGEN-28 (phase 4's model, bf16) on 2 ranks sharing the card
   over gloo, every collective staged through host memory, in one spawn
   that also runs the card sides of phases 63 and 65: the band graph with
   the halo exchange and the spatial × band route (K3 on the local band, K1
   on the halo partial and the leftover), the gather graph with the
   all-gather (K2's message form) and with the halo split (four K1 sums a
   forward); a rank's launches over a warm-up, a timed step and an eval
   forward must be exactly `spatial_expected`'s; the halo rows, collective
   calls, bytes staged, step time and peak a rank; the eval forward at seed
   0's weights against the single-process model within TOL_SPATIAL_BF16;
63. small models card against CPU: a DeeperGCN with batch norm across ranks
   and a RevGCN GEN with edge features, one spatial SGD step on 2 card ranks
   against 2 gloo ranks on the CPU, float32: loss and every updated entry;
64. a world of one over NCCL: the spatial ResGEN-28 step (all-gather route,
   K2's message form) against the single-process step on the same graph
   without its CSC, two Adam steps with deterministic algorithms, bit for
   bit;
65. cluster DP: two proteins-shaped clusters (phase 13's shape), one a
   rank, a RevGCN in float32, against the sequential mean of the two
   cluster losses' step on the card;
66. the apps with `--spatial 2`: ogbn-arxiv (ResGEN-28 bf16 on 80,000
   nodes, 2 epochs, `--save_ckpt`) and its test script on the checkpoint
   over the run's ranks (the printed best validation accuracy exactly) and
   in one process, the RevGCN proteins app at phase 18's argv, DyResGEN-7
   on 40,000 nodes, and ogbn-products' ResGEN-14 on 100,000 nodes for one
   epoch;
67. tensor-parallel ResGEN-28 (`parallel.tensor.TPDeeperGCN`: phase 4's
   model, its 128 channels over 2 ranks sharing the card over gloo, run in
   phase 62's spawn) on phase 4's whole gather graph: the eval logits at
   seed 0's weights against the single-process model within
   TOL_SPATIAL_BF16; a warm-up, a timed step and an eval forward whose
   launches a rank must be exactly `tp_expected`'s (K2's message form 28 a
   forward, K1's gathered form 28 a backward); the step a rank, collective
   calls, bytes staged and peak a rank;
68. (in phase 64's NCCL world of one) the tensor-parallel step at T=1 against
   the single-process step on the same graph without its CSC: two Adam
   steps with deterministic algorithms, losses and every entry bit for bit;
69. `TPRevGCN` (the proteins app's RevGCN-101 × 80, group 2, bf16: 20
   channels a group a rank) at T=2 on phase 13's cluster, in phase 62's
   spawn: the eval logits against the single-process RevGCN on the cluster
   without its CSC (the same gather and message form) within
   TOL_SPATIAL_BF16, a warm-up, a timed step and an eval forward with
   `tp_rev_expected`'s launches (K2's message form 2·L·G a step + L·G an
   eval, K1 L·G a step), the step and peak a rank;
70. spatial × tensor parallelism on a 2 × 2 grid of ranks sharing the card
   (`parallel.spatial_tp.SpatialTPDeeperGCN`): phase 62's shards of phase
   7's cluster-ordered graph with the halo exchange over gp, whose rows are
   now 64 channels wide; the gathered eval logits against the
   single-process model within TOL_SPATIAL_BF16, a warm-up, a timed step
   and an eval forward (K2's message form 28 a forward, no K1), the halo
   rows a layer, the step and peak a rank; then `apps/ogbn_arxiv` with
   `--tp 2` and with `--spatial 2 --tp 2` (ResGEN-28 bf16, phase 66's 80,000
   nodes, 2 epochs, `--save_ckpt`), each checkpoint scored by the test
   script in one process to the run's printed best validation accuracy
   exactly;
71. K11 (the fused norm → ReLU → dropout multiply, after phase 25) at the
   cells' shapes: N_pad = 169,472 rows (169,343 valid), RevGAT's C = 384 as
   row-stride-768 chunk views (a block: the shared float mask, and none as
   in evaluation) and C = 768 contiguous (the head: the bool keep mask with
   its 1/(1 − 0.75), and none); ResGEN-28's C = 128 (a res+ prologue: the
   keep mask with its 1/(1 − 0.5) and the running update, and the
   evaluation form on the running statistics); forward and backward against
   the plain halves (the backward given the kernel's own statistics, so
   both take the same ReLU gates) within TOL_K11, two launches bit for bit;
   each direction's device ms beside its byte bound and the plain halves'
   ms (the evaluation form a forward only).

Every time and memory figure of phases 30-71 is printed beside the card's
name and power limit. A failed comparison saves its tensors (K2's with its
inputs) under `chiprun_out/check_failures/` for replay.

The line before the last is a JSON object listing the kernels; the last line
is `{"ok": true, "device": {...}}`. `--rehearse-cpu` runs every phase on the
CPU at a tiny size through the plain versions, for checking the script
without a card; it prints no device result.

`--kernel-times` runs phase 1 and then only times K2 (C=128, and with `ee`
at C=40 and 64; and float32 C=128 on the `resgen28-arxiv-gather` benchmark
cell's graph as it is, without its long-row split, with every row cut to
128 edges and with its 8 longest rows alone), K4 (without dt at C=40, with
dt at C=64) and K10 (C=128) in float32 and bfloat16, K7, K8 and K9 in
bfloat16 at 3x128, 3x256 and 1x40 and in float32 at 3x128, and K5 and K6 in
bfloat16 at P=392, 776 and 48 and in float32 at P=392, at the shapes and on
the inputs of phases 6,
19, 25, 29 and 32, and K1 at phase 39's shapes (also as device times),
printing one JSON line and no device result. It uses the package beside
the script, so two commits compare on one card by copying this script into
a checkout of each (`git archive <commit>` into a git-ignored directory)
and running the copies in turns: parent, change, change, parent;
`--output-hashes` adds a digest of each K1, K5, K6 (its dmsg and d_el
columns apart), K7, K8 and K9 output, and of K2's on the cell's graph, to
that line, so that the two commits' kernels compare bit for bit.

`--norm-act` runs phase 1 and then only phase 71, printing its `kernels`
rows as one JSON line and no device result.

`--ogb` runs phase 1 and then only phases 40-46, printing their `kernels`
rows as one JSON line and no device result; `--pointcloud` likewise runs
phase 1 and phases 55-60; `--parallel` runs phase 1 and phases 61-70 and
prints no result line. The multi-rank times of phases 62-70 come from two
or four ranks sharing one card through host-staged gloo collectives: they
are printed as such and claim nothing.

`--kernel-forms[=K7,K9,K5,K8,K6,K1]` (card only; `--k7-forms` is
`--kernel-forms=K7`) runs phase 1 and then times the named kernels' forms
(all six when none is named), each a copy of the kernel's source with some
of the design's constants replaced and, for some, a list size, walk form or
lane layout of the wrapper changed (`KERNEL_FORMS`), at phases 25 and 29's
shapes (K1 at phase 39's, with device times, each form's output checked
bit for bit against the kept form's), printing one JSON line and no device
result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "deep_gcns_torch_tpu_torch"

# published peaks of one H100 SXM (NVIDIA data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# accurate expf takes one ex2 on the special-function units, 16 a clock per
# SM: 132 SMs at 1.98 GHz
SFU_EXP_PER_S = 16 * 132 * 1.98e9

# tolerances, kernel against plain version: |a - b| <= rtol*|b| + atol_rel*max|b|.
# Each per-edge term is bit for bit the same in kernel and plain version; only
# the order of the float32 sums differs, and in bf16 the final rounding of a
# sum may then land one ulp (2^-7 relative at most) away.
TOL_F32 = dict(rtol=1e-5, atol_rel=1e-5)          # summation order only
TOL_BF16 = dict(rtol=2.0 ** -7, atol_rel=1e-5)    # one bf16 ulp + summation order
# K2's lse is float32 in both dtypes, from the same bf16-rounded terms: only
# the order of den's float32 sum differs
TOL_LSE = TOL_F32
# backward in bf16: den, q and K1's output each round to bf16 once, so an ulp
# of difference can pass through up to three roundings
TOL_BWD_BF16 = dict(rtol=2.0 ** -5, atol_rel=1e-4)
# dt is a float32 sum over N*C terms with cancellation (a derivative of a
# sum of squares); in bf16 its terms carry the K1 output's ulps
TOL_DT = {"f32": dict(rtol=1e-4, atol_rel=0.0), "bf16": dict(rtol=1e-2, atol_rel=0.0)}
# the band route in bf16: A @ x is K3's sum plus the hub products plus K1's
# leftover sum, each rounded to bf16 before the next `+`, and the softmax
# quotient divides two such sums, so one ulp of a partial sum can move the
# result by a few ulps of its own
TOL_BAND_BF16 = dict(rtol=2.0 ** -5, atol_rel=1e-4)
# a max's gradient in bf16 by two routes: the gather + segment max rounds
# each edge's share g/ties to bf16 before K1 sums them, `band_extreme` sums
# the float32 shares; at a tie of 3 (frequent among bf16 maxima) the terms
# differ by one rounding of up to max|g|, which a sender's sum keeps
TOL_TIES_BF16 = dict(rtol=2.0 ** -7, atol_rel=2.0 ** -8)
BF16_TENSOR_FLOP_PER_S = 989e12   # dense bf16 tensor-core peak, for information
# the library yardstick (torch's bf16 sparse product) rounds its partial sums
# to bf16: its error reaches an ulp of the largest partial sum, which this
# floor covers while a different function would still miss by O(max|ref|)
TOL_LIBRARY = dict(rtol=2.0 ** -5, atol_rel=2.0 ** -5)
# the fused Function with edge embeddings and learned weights in bf16: one
# ulp of `out` moves the factor 1 + t·(m − out) of a single edge's term by
# t·2^-8·|out|, which may cancel to near 0, so the floor is one bf16 ulp of
# the largest value
TOL_EE_LEARN_T_BF16 = dict(rtol=2.0 ** -5, atol_rel=2.0 ** -7)
# K6's el column in bf16: each edge's term (⟨msg, gnum⟩ + gden)·w·lrelu' has
# a dot summed across the warp in the kernel and by torch in the plain
# version, so its bf16 rounding may flip by one ulp of the term; the floor is
# one bf16 ulp of the largest value
TOL_GAT_EL_BF16 = dict(rtol=2.0 ** -5, atol_rel=2.0 ** -7)
# the O(1)-memory check's allowance beside the optimizer state
MEMORY_SLACK_BYTES = 256 * 2 ** 20
# `nvidia-smi`'s name and power limit of the card, beside every time and
# memory figure of the later phases
CARD = "cpu (rehearsal)"
# the apps' experiment directories of the checkpoint phases (git-ignored,
# removed at the end)
RUNS = os.path.join(ROOT, "chiprun_out", "smoke_runs")


def log(*a):
    print(*a, flush=True)


T_START = time.time()


def mark(phase):
    log(f"[time] {phase} done at {time.time() - T_START:.1f}s")


# where a failed comparison leaves its tensors (git-ignored), for replay
FAIL_DIR = os.path.join(ROOT, "chiprun_out", "check_failures")


class Checks:
    """Prints every comparison; `raise_if_failed` ends a phase that had a miss.
    A failed `close` saves what it compared (and the ``inputs`` it was given)
    under `FAIL_DIR`, so that the miss can be replayed."""

    def __init__(self, phase):
        self.phase, self.failed = phase, []

    def close(self, name, got, want, rtol, atol_rel, ref_max=None, inputs=None):
        """``ref_max`` (default max|want|) scales the absolute floor."""
        raw = (got, want)
        got, want = got.detach().float(), want.detach().float()
        err = (got - want).abs()
        if ref_max is None:
            ref_max = float(want.abs().max()) if want.numel() else 0.0
        limit = rtol * want.abs() + atol_rel * ref_max
        max_err = float(err.max()) if err.numel() else 0.0
        ok = (got.shape == want.shape and bool(torch.isfinite(got).all())
              and bool((err <= limit).all()))
        log(f"[check] {name}: max_abs_err={max_err:.3e} (rtol={rtol:.3e}, "
            f"atol={atol_rel:.0e}*max|ref|={atol_rel * ref_max:.3e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            self.failed.append(name)
            self.save(name, *raw, inputs=inputs, limits=dict(rtol=rtol, atol_rel=atol_rel,
                                                             ref_max=ref_max))
        return max_err

    def save(self, name, got, want, inputs=None, limits=None):
        os.makedirs(FAIL_DIR, exist_ok=True)
        safe = "".join(ch if ch.isalnum() or ch in "-_." else "_" for ch in name)
        path = os.path.join(FAIL_DIR, f"{self.phase}-{safe}.pt")

        def cpu(v):
            return v.detach().cpu() if isinstance(v, torch.Tensor) else v

        torch.save({"phase": self.phase, "name": name, "got": cpu(got), "want": cpu(want),
                    "limits": limits, "inputs": {k: cpu(v) for k, v in (inputs or {}).items()},
                    "torch": torch.__version__, "threads": torch.get_num_threads()}, path)
        log(f"[check] {name}: compared tensors saved to {path}")

    def equal(self, name, got, want):
        """Bit for bit (``==``, so 0.0 and -0.0 agree)."""
        ok = got.shape == want.shape and bool((got == want).all())
        log(f"[check] {name}: equal {'ok' if ok else 'FAIL'}")
        if not ok:
            self.failed.append(name)

    def raise_if_failed(self):
        if self.failed:
            raise AssertionError(f"{self.phase}: {len(self.failed)} checks failed: "
                                 f"{self.failed}")


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def phase_device(dev):
    log(f"[device] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if dev.type != "cuda":
        return {}
    # float32 products in full float32, as the plain versions and the JAX
    # package compute them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nvcc = _build.nvcc_path()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=True)
    log(f"[device] nvcc: {ver.stdout.strip().splitlines()[-1]}")
    global CARD
    name_limit = CARD = smi("name,power.limit")
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"nvidia-smi: {name_limit}")
    t0 = time.time()
    paths = _build.build(verbose=True)
    log(f"[build] {len(paths)} libraries in {time.time() - t0:.1f}s: "
        f"{sorted(os.path.basename(p) for p in paths.values())}")
    return {"smi": name_limit}


def main_graph(n, dev):
    t0 = time.time()
    g, labels = random_node_graph(np.random.default_rng(0), n, 14, 128, num_classes=40,
                                  self_loops=True)
    log(f"[graph] N={g.n_node} E={g.n_edge} N_pad={g.num_nodes_padded} "
        f"E_pad={g.num_edges_padded} built in {time.time() - t0:.1f}s")
    return g.to(dev), labels


def phase_kernels(g):
    """K1 (both forms), K2 and K4's gather form in f32 and bf16, and the
    autograd backward, against the plain versions on the same inputs."""
    dev = g.senders.device
    chk = Checks("kernels")
    gen = torch.Generator(device=dev).manual_seed(1)
    errs = {}
    t = torch.tensor([0.1], device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        tag = "f32" if dtype == torch.float32 else "bf16"
        x = g.x.to(dtype).contiguous()
        out, lse = tsp.softmax_agg(x, g.senders, g.row_ptr, g.row_order, t, 1e-7)
        out_p, lse_p = tsp.softmax_agg_plain(x, g.senders, g.row_ptr, g.row_order, t, 1e-7)
        k2_in = dict(x=x, senders=g.senders, row_ptr=g.row_ptr, t=t, eps=1e-7)
        e2 = max(chk.close(f"K2 out {tag}", out, out_p, inputs=k2_in, **tol),
                 chk.close(f"K2 lse {tag}", lse, lse_p, inputs=k2_in, **TOL_LSE))
        out2, lse2 = tsp.softmax_agg(x, g.senders, g.row_ptr, g.row_order, t, 1e-7)
        chk.equal(f"K2 {tag} two launches bit for bit (out)", out2, out)
        chk.equal(f"K2 {tag} two launches bit for bit (lse)", lse2, lse)
        del out2, lse2
        e4 = 0.0
        q = torch.randn(g.num_nodes_padded, 128, device=dev, generator=gen).to(dtype)
        for gw in (False, True):
            qo = torch.cat([q, out_p], 1).contiguous() if gw else q
            # without dt the kernel reads K2's own lse (the plain version the
            # plain one's), so a kernel lse off by more than the order of
            # den's sum shows in dx as well
            args = (x, None, qo, lse_p, g.csc_col_ptr, g.csc_order, g.csc_receivers, t, 1e-7, gw)
            args_k = args if gw else args[:3] + (lse,) + args[4:]
            dx, dee, dt = tsp.softmax_bwd_csc(*args_k)
            dx_p, _, dt_p = tsp.softmax_bwd_csc_plain(*args)
            name = f"K4 gather {'dt' if gw else 'no-dt'} {tag}"
            e4 = max(e4, chk.close(f"{name} dx", dx, dx_p, inputs=dict(args=args), **tol))
            if dee is not None:
                raise AssertionError(f"{name}: the gather form returned a d(ee)")
            dx2, _, dt2 = tsp.softmax_bwd_csc(*args_k)
            chk.equal(f"{name} two launches bit for bit (dx)", dx2, dx)
            if gw:
                chk.close(f"{name} dt", dt, dt_p, **TOL_DT["f32"])
                chk.equal(f"{name} two launches bit for bit (dt)", dt2, dt)
            del dx, dx_p, dx2
        del q
        msgs = torch.randn(g.num_edges_padded, 128, device=dev, generator=gen).to(dtype)
        e1a = chk.close(f"K1 plain form {tag}", tsp.csr_seg_sum(msgs, g.row_ptr),
                        tsp.csr_seg_sum_plain(msgs, g.row_ptr), **tol)
        src = torch.randn(g.num_nodes_padded, 128, device=dev, generator=gen).to(dtype)
        e1b = chk.close(f"K1 gathered form {tag}",
                        tsp.csr_seg_sum(src, g.csc_col_ptr, g.csc_receivers),
                        tsp.csr_seg_sum_plain(src, g.csc_col_ptr, g.csc_receivers), **tol)
        del msgs, src, out, lse, out_p, lse_p
        tol_b = TOL_F32 if dtype == torch.float32 else TOL_BWD_BF16
        for gw in (False, True):
            res = []
            for fn in (tsp.fused_softmax_gather_agg, tsp.fused_softmax_gather_agg_plain):
                xx = x.detach().clone().requires_grad_(True)
                tt = t.clone().requires_grad_(gw)
                o = fn(xx, g.senders, g.row_ptr, g.row_order, g.csc_receivers, g.csc_col_ptr,
                       g.csc_order, tt, eps=1e-7, grad_weights=gw)
                (o.float() ** 2).sum().backward()
                res.append((o.detach(), xx.grad, tt.grad))
            name = f"backward {'learn_t' if gw else 'softmax_sg'} {tag}"
            chk.close(f"{name} out", res[0][0], res[1][0], **tol)
            e1b = max(e1b, chk.close(f"{name} dx", res[0][1], res[1][1], **tol_b))
            if gw:
                chk.close(f"{name} dt", res[0][2], res[1][2], **TOL_DT[tag])
            del res
        errs[tag] = {"K1": max(e1a, e1b), "K2": e2, "K4": e4}
    corner = k2_corner_graph(dev)
    k2_corner_checks(chk, corner, False, gen)
    fused_split_checks(chk, corner, False, gen)
    k4_corner_checks(chk, corner, gen, with_ee=False)
    sync(dev)
    chk.raise_if_failed()
    return errs


def k2_corner_graph(dev):
    """K2's and K4's corner cases in one graph: 3,000 nodes, 30,000 random
    edges with 8-dim edge features, a hub row of 5,000 in-edges (row 11),
    rows of exactly D − 1, D and D + 1 in-edges (rows 20, 21 and 22, D =
    `K2_SPLIT_EDGES`, so that K2 splits the hub and row 22) and 100 rows
    with no edge (the last nodes receive none); for K4, whose rows are
    senders, a hub sender of 4,000 out-edges (node 17) and 100 senders with
    no edge (the 100 nodes before the last 100 send none)."""
    rng = np.random.default_rng(13)
    n, e, d = 3000, 30_000, tsp.K2_SPLIT_EDGES
    s, r = rng.integers(0, n, e), rng.integers(0, n - 100, e)
    r[:5000] = 11
    r[(r >= 20) & (r <= 22)] = 23
    r[9000:9000 + 3 * d] = np.repeat([20, 21, 22], [d - 1, d, d + 1])
    s[(s >= n - 200) & (s < n - 100)] = 17
    s[5000:9000] = 17
    return build_graph(None, s, r, edge_attr=rng.random((e, 8)).astype(np.float32),
                       num_nodes=n).to(dev)


def k2_corner_checks(chk, g, with_ee, gen):
    """K2 (with ``ee`` or without) against its plain version on
    `k2_corner_graph` at C = 40, 64 and 128 (3, 2 and 1 lane groups) and 41
    (the scalar form), float32 and bf16: the hub row within the tolerance,
    the rows with no edge exact 0 (out and lse), two launches bit for bit
    the same; and K2's long-row split (`k2_split_checks`)."""
    dev = g.senders.device
    t = torch.tensor([0.7], device=dev)
    empty = (g.row_ptr[1:] == g.row_ptr[:-1]).nonzero()[:, 0]
    name = "K2 ee" if with_ee else "K2"
    if g.split_rows != 2 or sorted(g.row_order[:2].tolist()) != [11, 22]:
        raise AssertionError(f"corner graph: K2 splits rows {g.row_order[:g.split_rows]}, "
                             "not the hub (11) and the row of D + 1 edges (22)")
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        tag = "f32" if dtype == torch.float32 else "bf16"
        for c in (40, 64, 128, 41):
            x, ee, _ = edge_inputs(g, c, dtype, gen)
            ee = ee if with_ee else None
            out, lse = tsp.softmax_agg(x, g.senders, g.row_ptr, g.row_order, t, 1e-7, ee)
            out_p, lse_p = tsp.softmax_agg_plain(x, g.senders, g.row_ptr, g.row_order, t, 1e-7, ee)
            k2_in = dict(x=x, ee=ee, senders=g.senders, row_ptr=g.row_ptr, t=t, eps=1e-7)
            chk.close(f"{name} corner graph out C={c} {tag}", out, out_p, inputs=k2_in, **tol)
            chk.close(f"{name} corner graph lse C={c} {tag}", lse, lse_p, inputs=k2_in,
                      **TOL_LSE)
            zero = torch.zeros(len(empty), c, dtype=dtype, device=dev)
            chk.equal(f"{name} rows with no edge exact 0 C={c} {tag} (out)", out[empty], zero)
            chk.equal(f"{name} rows with no edge exact 0 C={c} {tag} (lse)", lse[empty],
                      zero.float())
            out2, lse2 = tsp.softmax_agg(x, g.senders, g.row_ptr, g.row_order, t, 1e-7, ee)
            chk.equal(f"{name} two launches bit for bit C={c} {tag} (out)", out2, out)
            chk.equal(f"{name} two launches bit for bit C={c} {tag} (lse)", lse2, lse)
            k2_split_checks(chk, g, (x, g.senders, g.row_ptr, g.row_order, t, 1e-7, ee),
                            (out, lse), (out_p, lse_p), f"{name} C={c} {tag}", tol)


def k2_split_rows_counted(c, dtype, dev, n_split):
    """What a K2 launch adds to `softmax_agg.split_rows`: the rows it split,
    all ``n_split`` in the one-group layout (float32, and bf16 rows of 32
    vector slots or more) on the card; none in the grouped bf16 layouts, and
    none on the CPU, where the plain version runs."""
    one_group = tsp.k2_lane_groups(c, 4 if c % 4 == 0 else 1, dtype)[1] == 1
    return n_split if one_group and dev.type == "cuda" else 0


def k2_split_checks(chk, g, args, unsplit, plain, name, tol):
    """K2's long-row split: the launch of ``args`` with the graph's own
    count of split rows (`Graph.split_rows`) and with every row split
    (short and empty rows too) against the plain version within ``tol``,
    bit for bit the launch that splits none (``unsplit``), and counted in
    `softmax_agg.split_rows`."""
    x = args[0]
    n_rows = g.row_ptr.shape[0] - 1
    for k, how in ((g.split_rows, "long rows"), (n_rows, "every row")):
        before = tsp.softmax_agg.split_rows
        out, lse = tsp.softmax_agg(*args, split_rows=k)
        grew = tsp.softmax_agg.split_rows - before
        want = k2_split_rows_counted(x.shape[1], x.dtype, x.device, k)
        sname = f"{name} {how} split"
        chk.close(f"{sname} out", out, plain[0], **tol)
        chk.close(f"{sname} lse", lse, plain[1], **TOL_LSE)
        chk.equal(f"{sname} bit for bit the unsplit launch (out)", out, unsplit[0])
        chk.equal(f"{sname} bit for bit the unsplit launch (lse)", lse, unsplit[1])
        chk.equal(f"{sname} counted ({grew} rows, {want} expected)", torch.tensor(grew),
                  torch.tensor(want))


def fused_split_checks(chk, g, with_ee, gen):
    """The fused Function on `k2_corner_graph` at C = 128, float32 and bf16,
    softmax_sg and learn_t: forward and backward with K2 splitting the
    graph's long rows (``split_rows=g.split_rows``, as GENConv passes it)
    against the Function on the plain versions within the phase's
    tolerances, bit for bit the Function that splits none, and one forward's
    split rows counted."""
    dev = g.senders.device
    c = 128
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        x, ee, ee_csc = edge_inputs(g, c, dtype, gen)
        ee, ee_csc = (ee, ee_csc) if with_ee else (None, None)
        co = torch.randn(g.num_nodes_padded, c, device=dev, generator=gen)
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        for gw in (False, True):
            res = []
            for fn, k in ((tsp.fused_softmax_gather_agg, g.split_rows),
                          (tsp.fused_softmax_gather_agg, 0),
                          (tsp.fused_softmax_gather_agg_plain, g.split_rows)):
                xx = x.detach().clone().requires_grad_(True)
                ec = None if ee_csc is None else ee_csc.detach().clone().requires_grad_(True)
                tt = torch.tensor([0.7], device=dev).requires_grad_(gw)
                before = tsp.softmax_agg.split_rows
                o = fn(xx, g.senders, g.row_ptr, g.row_order, g.csc_receivers, g.csc_col_ptr,
                       g.csc_order, tt, ee=ee, ee_csc=ec, eps=1e-7, grad_weights=gw,
                       split_rows=k)
                (o.float() * co).sum().backward()
                res.append((tsp.softmax_agg.split_rows - before,
                            [o.detach(), xx.grad] + ([ec.grad] if with_ee else [])
                            + ([tt.grad] if gw else [])))
            name = (f"fused {'ee ' if with_ee else ''}{'learn_t' if gw else 'softmax_sg'} "
                    f"long rows split C={c} {tag}")
            tol_b = (TOL_F32 if dtype == torch.float32 else
                     TOL_EE_LEARN_T_BF16 if gw and with_ee else TOL_BWD_BF16)
            parts = ["out", "dx"] + (["d(ee_csc)"] if with_ee else []) + (["dt"] if gw else [])
            for i, part in enumerate(parts):
                lim = (tol if part == "out" else TOL_DT[tag] if part == "dt" else tol_b)
                chk.close(f"{name} {part}", res[0][1][i], res[2][1][i], **lim)
                chk.equal(f"{name} {part} bit for bit the unsplit Function", res[0][1][i],
                          res[1][1][i])
            want = k2_split_rows_counted(c, dtype, dev, g.split_rows)
            chk.equal(f"{name} counted ({res[0][0]} rows, {want} expected)",
                      torch.tensor(res[0][0]), torch.tensor(want))
            del res


def k4_corner_checks(chk, g, gen, with_ee=True):
    """K4 (its `ee` form, or its gather form without) against its plain
    version on `k2_corner_graph` at C = 40, 64 and 128 (3, 2 and 1 lane
    groups in bf16, one in float32) and 41 (the scalar form), float32 and
    bf16, with and without dt: the hub sender's 4,000 edges within the
    tolerance, the senders with no edge exact 0 in dx, the padding rows of
    dee exact 0, two launches bit for bit the same."""
    dev = g.senders.device
    t = torch.tensor([0.7], device=dev)
    ptr = g.csc_col_ptr
    no_edge = (ptr[1:] == ptr[:-1]).nonzero()[:, 0]
    hub = int((ptr[1:] - ptr[:-1]).argmax())
    log(f"[edge kernels] K4 corner graph: sender {hub} has {int(ptr[hub + 1] - ptr[hub])} "
        f"out-edges, {len(no_edge)} senders have none")
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        tag = "f32" if dtype == torch.float32 else "bf16"
        for c in (40, 64, 128, 41):
            x, ee, ee_csc = edge_inputs(g, c, dtype, gen)
            if not with_ee:
                ee = ee_csc = None
            _, lse = tsp.softmax_agg_plain(x, g.senders, g.row_ptr, g.row_order, t, 1e-7, ee)
            q = torch.randn(g.num_nodes_padded, c, device=dev, generator=gen).to(dtype)
            out = torch.randn(g.num_nodes_padded, c, device=dev, generator=gen).to(dtype)
            for gw in (False, True):
                qo = torch.cat([q, out], 1).contiguous() if gw else q
                args = (x, ee_csc, qo, lse, ptr, g.csc_order, g.csc_receivers, t, 1e-7, gw)
                dx, dee, dt = tsp.softmax_bwd_csc(*args)
                dx_p, dee_p, dt_p = tsp.softmax_bwd_csc_plain(*args)
                name = (f"K4{'' if with_ee else ' gather'} corner graph "
                        f"{'dt' if gw else 'no-dt'} C={c} {tag}")
                chk.close(f"{name} dx", dx, dx_p, **tol)
                chk.equal(f"{name} senders with no edge exact 0 (dx)", dx[no_edge],
                          torch.zeros(len(no_edge), c, dtype=dtype, device=dev))
                if with_ee:
                    chk.close(f"{name} dee", dee, dee_p, **tol)
                    chk.equal(f"{name} dee padding rows exact 0", dee[g.n_edge:],
                              torch.zeros_like(dee[g.n_edge:]))
                dx2, dee2, dt2 = tsp.softmax_bwd_csc(*args)
                chk.equal(f"{name} two launches bit for bit (dx)", dx2, dx)
                if with_ee:
                    chk.equal(f"{name} two launches bit for bit (dee)", dee2, dee)
                if gw:
                    chk.close(f"{name} dt", dt, dt_p, **TOL_DT["f32"])
                    chk.equal(f"{name} two launches bit for bit (dt)", dt2, dt)


def without_csc(g):
    """``g`` without its CSC auxiliaries, what `build_graph(...,
    with_csc=False)` gives: GENConv then takes its unfused branch."""
    return g.replace(csc_perm=None, csc_senders=None, csc_col_ptr=None, csc_receivers=None,
                     edge_attr_csc=None)


def phase_agreement(dev, aggr="softmax", csc=True):
    """A small DeeperGCN on ``dev`` against the same weights on the CPU
    (``aggr`` "softmax" with a learned t: K2 and K1; "mean": K1 both ways;
    without ``csc`` the unfused branch: K2's message form)."""
    tag = aggr if csc else f"{aggr} no-csc"
    chk = Checks(f"agreement {tag}")
    gc, _ = random_node_graph(np.random.default_rng(2), 3000, 10, 32, num_classes=7,
                              self_loops=True)
    if not csc:
        gc = without_csc(gc)
    cfg = DeeperGCNConfig(in_channels=32, hidden_channels=64, num_tasks=7, num_layers=4,
                          block="res+", aggr=aggr, learn_t=aggr == "softmax", t=0.5,
                          norm="batch", mlp_layers=1, dropout=0.0)
    co = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (gc.num_nodes_padded, 7)).astype(np.float32))
    outs = []
    for d in (dev, torch.device("cpu")):
        model = DeeperGCN(cfg, generator=torch.Generator().manual_seed(0)).to(d)
        model.train()
        gd = gc.to(d)
        logits = model(gd.x, gd)
        (logits * co.to(d)).sum().backward()
        outs.append((logits.detach().cpu(),
                     {k: p.grad.detach().cpu() for k, p in model.named_parameters()}))
    # float32 through 4 layers: summation order in K1/K2, BatchNorm and
    # matmuls. The absolute floor of the gradients is set by the largest
    # gradient of all: a bias that feeds a BatchNorm has a true gradient of 0,
    # and what both devices return for it is rounding noise.
    chk.close(f"small DeeperGCN {tag} logits, card vs cpu", outs[0][0], outs[1][0], 1e-4,
              1e-4)
    g_max = max(float(v.abs().max()) for v in outs[1][1].values())
    for k in outs[1][1]:
        chk.close(f"small DeeperGCN {tag} grad {k}", outs[0][1][k], outs[1][1][k], 1e-3,
                  1e-4, ref_max=g_max)
    chk.raise_if_failed()


def main_model(dev, layers, aggr="softmax_sg"):
    cfg = DeeperGCNConfig(in_channels=128, hidden_channels=128, num_tasks=40,
                          num_layers=layers, block="res+", aggr=aggr, t=0.1,
                          norm="batch", mlp_layers=1, dropout=0.5,
                          compute_dtype="bfloat16")
    model = DeeperGCN(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    return model, make_optimizer("adam", model.parameters(), 1e-2)


def _counted():
    return {"K1": (tsp.csr_seg_sum, "launches"), "K2": (tsp.softmax_agg, "launches"),
            "K2 ee": (tsp.softmax_agg, "launches_ee"),
            "K2 msgs": (tsp.softmax_agg_msgs, "launches"), "K3": (tband.band_call, "launches"),
            "K4": (tsp.softmax_bwd_csc, "launches"), "K5": (tsp.gat_fwd, "launches"),
            "K6": (tsp.gat_bwd_csc, "launches"), "K7": (tgd.win_fused, "launches"),
            "K8": (tgd.win_der, "launches"), "K9": (tgd.win_dsend, "launches"),
            "K10": (tbs.block_spmm, "launches"),
            "K11 fwd": (tna.batch_norm_act_fwd, "launches"),
            "K11 bwd": (tna.batch_norm_act_bwd, "launches")}


def reset_launches():
    for fn, attr in _counted().values():
        setattr(fn, attr, 0)


def read_launches():
    return {k: getattr(fn, attr) for k, (fn, attr) in _counted().items()}


def no_launches():
    return {k: 0 for k in _counted()}


def k11_expected(model, forwards, backwards):
    """K11's launches in ``forwards`` forwards and ``backwards`` backwards of
    a DeeperGCN on the card: one a res+ prologue and one for the final norm
    with its ReLU, where `models.deeper_gcn.norm_relu_dropout` routes them
    (a BatchNorm with its own moments, a float32 residual stream)."""
    c, norm = model.cfg, model.norms[0]
    if (c.block != "res+" or not isinstance(norm, BatchNorm) or norm.cross_rank
            or c.residual_dtype != "float32"):
        return {}
    k = c.num_layers - 1 + int(c.final_relu)
    return {"K11 fwd": k * forwards, "K11 bwd": k * backwards}


def expected_launches(g, layers, steps, aggr="softmax_sg"):
    """Kernel launches of (steps + 1) train steps and one `predict`: every
    forward runs one aggregation per layer, every backward one more. The
    gather route runs K2 forward and K4's gather form backward (the mean
    route K1 both ways: the CSR sum forward, the gather's CSC sum backward; a
    graph without its CSC the unfused branch: K2's message form forward,
    nothing backward); the band route K3 both ways, plus K1 wherever that
    direction's leftover is not empty. Every route runs K11 once a layer
    each way (`main_model`'s 27 prologues and its final norm)."""
    want = no_launches()
    if g.senders.device.type != "cuda":
        return want  # CPU tensors never launch a kernel
    fwd, bwd = layers * (steps + 2), layers * (steps + 1)
    want.update({"K11 fwd": fwd, "K11 bwd": bwd})
    if g.band is None:
        if g.csc_col_ptr is None:
            # no CSC: the unfused branch, whose gather has a plain backward;
            # the softmax family aggregates through K2's message form
            want.update(K1=fwd) if aggr == "mean" else want.update({"K2 msgs": fwd})
        elif aggr == "mean":
            want.update(K1=fwd + bwd)
        else:
            want.update(K4=bwd, K2=fwd)
        return want
    lo_f, lo_b = int(g.band.fwd.n_lo > 0), int(g.band.bwd.n_lo > 0)
    want.update(K1=fwd * lo_f + bwd * lo_b, K3=fwd + bwd)
    return want


def phase_main_path(g, labels, layers, steps, tag="main", aggr="softmax_sg"):
    """ResGEN-28 (its aggregator ``aggr``) through the app's `train_step` and
    `predict` on ``g``; the launch counts are set to 0 just before and read
    just after."""
    dev = g.senders.device
    n = g.n_node
    lab = torch.zeros(g.num_nodes_padded, dtype=torch.long)
    lab[:n] = torch.from_numpy(np.asarray(labels))
    lab = lab.to(dev)
    model, opt = main_model(dev, layers, aggr)
    gen = torch.Generator(device=dev).manual_seed(1)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    reset_launches()
    loss = ogbn_arxiv.train_step(model, opt, g, lab, g.node_mask, gen)  # warm-up
    sync(dev)
    losses, times = [float(loss)], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = ogbn_arxiv.train_step(model, opt, g, lab, g.node_mask, gen)
        sync(dev)
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    t0 = time.perf_counter()
    pred = ogbn_arxiv.predict(model, g)
    sync(dev)
    predict_s = time.perf_counter() - t0
    launches = read_launches()

    log(f"[{tag}] losses {losses}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{tag}: loss is not finite")
    if pred.shape != (g.num_nodes_padded,) or int(pred.min()) < 0 or int(pred.max()) >= 40:
        raise AssertionError(f"{tag}: predict gave shape {tuple(pred.shape)} range "
                             f"[{int(pred.min())}, {int(pred.max())}]")
    want = expected_launches(g, layers, steps, aggr)
    log(f"[{tag}] launches {launches} expected {want}")
    if launches != want:
        raise AssertionError(f"{tag}: kernel launches {launches} != expected {want}")
    step = sorted(times)[len(times) // 2]
    info = {"step_ms_median": step * 1e3, "step_ms_min": min(times) * 1e3,
            "step_ms_all": [v * 1e3 for v in times], "predict_ms": predict_s * 1e3,
            "edge_messages_per_s": g.n_edge * layers / step, "launches": launches}
    if dev.type == "cuda":
        info["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(dev)
        info["smi_after_steps"] = smi("clocks.sm,power.draw,temperature.gpu")
    log(f"[{tag}] {json.dumps(info)}; card: {CARD}")
    return info, (model, opt, lab, gen)


def arxiv_step(g, state):
    model, opt, lab, gen = state
    return lambda: ogbn_arxiv.train_step(model, opt, g, lab, g.node_mask, gen)


def phase_profile(dev, step, tag="profile"):
    """Device time by kernel over one call of the train step ``step``, and
    the device's busy share of that window (host clock around the step,
    ending in a sync). On the card only the device activity is traced."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.time()
    acts = [ProfilerActivity.CUDA if dev.type == "cuda" else ProfilerActivity.CPU]
    sync(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        sync(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, memory copies and sets), summed by
    # name straight from the trace: building torch's per-event objects for
    # `key_averages()` takes seconds at ~30,000 events
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CPU and e.duration_ns() > 0:
            us, count = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (us + e.duration_ns() / 1e3, count + 1)
    rows = sorted(((us, count, key) for key, (us, count) in by_name.items()), reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[{tag}] 1 train step: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}% of the window), "
        f"{sum(r[1] for r in rows)} device calls")
    # the 40 largest rows, and every kernel of the port's (`dgc::`) below them
    for dev_us, count, key in rows[:40] + [r for r in rows[40:] if "dgc::" in r[2]]:
        log(f"[{tag}] {dev_us / 1e3:10.3f} ms {count:6d} calls "
            f"{100 * dev_us / max(busy, 1e-9):5.1f}%  {key[:160]}")
    log(f"[{tag}] traced and read in {time.time() - t_phase:.1f}s")


def time_fn(fn, dev, iters):
    """Mean time of one call: CUDA events around `iters` calls on the card,
    the host clock on the CPU; after warm-up calls."""
    for _ in range(2):
        fn()
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def device_ms(fn, dev, iters):
    """Device time of one call: CUDA events around `iters` calls queued
    behind a ~10 ms sleep kernel, so that the card runs them back to back.
    Unlike `time_fn` it leaves out the host's launch gaps, which set
    `time_fn`'s reading of a kernel shorter than the wrapper's launch (K1's
    narrow shapes). The host clock on the CPU."""
    if dev.type != "cuda":
        return time_fn(fn, dev, iters)
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    torch.cuda._sleep(20_000_000)  # 2e7 clocks: longer than enqueueing the calls
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / iters


def bound(bytes_moved, flops, exps=0):
    """The least time for the work: bytes over the memory rate, or float32
    operations over their rate, or accurate `expf` calls over the
    special-function units' rate, whichever is larger."""
    b_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    f_ms = max(flops / F32_FLOP_PER_S, exps / SFU_EXP_PER_S) * 1e3
    return (b_ms, "bytes") if b_ms >= f_ms else (f_ms, "operations")


def phase_timing(g, errs, launches, iters):
    """K1 (gathered form), K2 and K4's gather form in bf16 at the main path's
    shapes."""
    dev = g.senders.device
    chk = Checks("timing")
    n_pad, e, c = g.num_nodes_padded, g.n_edge, 128
    x = g.x.to(torch.bfloat16).contiguous()
    t = torch.tensor([0.1], device=dev)
    q = torch.randn(n_pad, c, device=dev).to(torch.bfloat16)
    k2_args = (x, g.senders, g.row_ptr, g.row_order, t, 1e-7)
    k2_ms = time_fn(lambda: tsp.softmax_agg(*k2_args), dev, iters)
    k2_plain = time_fn(lambda: tsp.softmax_agg_plain(*k2_args), dev, 3)
    _, lse = tsp.softmax_agg(x, g.senders, g.row_ptr, g.row_order, t, 1e-7)
    k4_args = (x, None, q, lse, g.csc_col_ptr, g.csc_order, g.csc_receivers, t, 1e-7, False)
    k4_ms = time_fn(lambda: tsp.softmax_bwd_csc(*k4_args), dev, iters)
    k4_plain = time_fn(lambda: tsp.softmax_bwd_csc_plain(*k4_args), dev, 3)
    k1_ms = time_fn(lambda: tsp.csr_seg_sum(q, g.csc_col_ptr, g.csc_receivers), dev, iters)
    k1_plain = time_fn(lambda: tsp.csr_seg_sum_plain(q, g.csc_col_ptr, g.csc_receivers),
                       dev, 3)
    # yardstick (never called by the port): the same sum as one sparse product
    # with the CSR matrix Aᵀ[n, r] = #edges n→r (repeated edges summed), built
    # once. The CPU rehearsal runs it in float32: the CPU's sparse product has
    # no bfloat16.
    qy = q if dev.type == "cuda" else q.float()
    coo = torch.sparse_coo_tensor(
        torch.stack([g.csc_senders[:e].long(), g.csc_receivers[:e].long()]),
        torch.ones(e, device=dev), (n_pad, n_pad),
        check_invariants=True).coalesce().to_sparse_csr()
    at = torch.sparse_csr_tensor(coo.crow_indices(), coo.col_indices(),
                                 coo.values().to(qy.dtype), (n_pad, n_pad),
                                 check_invariants=True)
    lib_ms = time_fn(lambda: torch.sparse.mm(at, qy), dev, iters)
    chk.close("library yardstick sparse.mm vs K1", torch.sparse.mm(at, qy),
              tsp.csr_seg_sum(q, g.csc_col_ptr, g.csc_receivers), **TOL_LIBRARY)
    chk.raise_if_failed()

    idx_b = 4 * e + 4 * (n_pad + 1)
    # K1: q read once, out written once (bf16), the CSC index and pointer; one
    # f32 add per (edge, channel)
    k1_bound = bound(2 * n_pad * c * 2 + idx_b, e * c)
    # K2: x read once, out written once (bf16) and lse (float32), senders,
    # row_ptr and t; per (edge, channel): the first walk's max, mul and max,
    # then max, add, mul, sub, exp, mul, 2 roundings, 2 adds
    k2_bound = bound(n_pad * c * 2 + idx_b + 4 + n_pad * c * 2 + n_pad * c * 4, 13 * e * c,
                     e * c)
    # K4's gather form: x, q (bf16) and lse (float32) read once, dx written
    # once (bf16), the CSC receivers and pointers and t; per (edge, channel):
    # max, add, mul, sub, exp, mul, select, rounding, add
    k4_bound = bound(n_pad * c * 2 * 3 + n_pad * c * 4 + idx_b + 4, 9 * e * c, e * c)
    rows = [
        {"name": "K1 seg_sum_csr", "route": "cuda",
         "source": f"{PKG}/csrc/seg_sum.cu",
         "replaces": "deep_gcns_torch_tpu/ops/spmm_pallas.py:252",
         "launches": launches["K1"], "max_abs_err": errs["bf16"]["K1"], "ms": k1_ms,
         "plain_ms": k1_plain, "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
         "library_ms": lib_ms},
        {"name": "K2 softmax_agg", "route": "cuda",
         "source": f"{PKG}/csrc/softmax_agg.cu",
         "replaces": "deep_gcns_torch_tpu/ops/spmm_pallas.py:322",
         "launches": launches["K2"], "max_abs_err": errs["bf16"]["K2"], "ms": k2_ms,
         "plain_ms": k2_plain, "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
         "library_ms": None},
        {"name": "K4 softmax_bwd_csc gather", "route": "cuda",
         "source": f"{PKG}/csrc/softmax_bwd_csc.cu",
         "replaces": "deep_gcns_torch_tpu/ops/spmm_pallas.py:727-760 (K1's gathered form)",
         "launches": launches["K4"], "max_abs_err": errs["bf16"]["K4"], "ms": k4_ms,
         "plain_ms": k4_plain, "bound_ms": k4_bound[0], "bound_by": k4_bound[1],
         "library_ms": None},
    ]
    log("[timing] K2 has no single PyTorch call that computes it: library_ms is null")
    log(f"[timing] max errors f32 {errs['f32']} bf16 {errs['bf16']}; "
        f"exp count per K2 call {e * c}")
    log(f"[timing] K2 {k2_ms:.4f} ms, bound {k2_bound[0]:.4f} ms ({k2_bound[1]}: the larger "
        f"of bytes, float32 operations and {e * c} accurate expf on the special-function "
        f"units); card: {CARD}")
    log(f"[timing] K4 gather {k4_ms:.4f} ms, bound {k4_bound[0]:.4f} ms ({k4_bound[1]}); "
        f"card: {CARD}")
    return rows


def band_graph(n, dev):
    """The realistic graph of the band route, built on the host: power-law
    community edges, cluster order, features, then the band (window and hubs
    "auto")."""
    t0 = time.time()
    lib_ok = native.available()  # builds the host library with g++ on first use
    t_lib = time.time() - t0
    if not lib_ok:
        raise AssertionError("the native host library did not build or load: the band "
                             "builder would run its numpy version")
    rng = np.random.default_rng(0)
    t0 = time.time()
    s, r = powerlaw_community_edges(rng, n, 15)
    t_edges = time.time() - t0
    t0 = time.time()
    perm = cluster_order(s, r, n, cluster_size=16384)
    s, r = permute_graph(perm, s, r)
    t_order = time.time() - t0
    x = rng.standard_normal((n, 128)).astype(np.float32)
    labels = rng.integers(0, 40, n)
    g = build_graph(x, s, r, num_nodes=n)
    t0 = time.time()
    g = attach_band(g)
    t_band = time.time() - t0
    g = g.to(dev)
    sync(dev)
    f, b = g.band.fwd, g.band.bwd
    info = {"n": g.n_node, "e": g.n_edge, "n_pad": g.num_nodes_padded,
            "native_library_s": t_lib, "edges_s": t_edges, "cluster_order_s": t_order,
            "attach_band_s": t_band,
            "window": [f.window, b.window], "coverage": [f.coverage, b.coverage],
            "n_hub": [f.n_hub, b.n_hub], "n_hub_row": [f.n_hub_row, b.n_hub_row],
            "n_lo": [f.n_lo, b.n_lo],
            "hub_cols": [0 if x_.hub_ids is None else x_.hub_ids.numel() for x_ in (f, b)],
            "hub_rows": [0 if x_.hub_row_ids is None else x_.hub_row_ids.numel()
                         for x_ in (f, b)],
            "band_device_bytes": g.band.nbytes()}
    log(f"[band-graph] (fwd, bwd) {json.dumps(info)}")
    return g, labels, info


def phase_band_kernels(g):
    """K3 against its plain version, and the band Functions forward and
    backward on the kernels against the same Functions on the plain versions."""
    dev = g.senders.device
    chk = Checks("band kernels")
    gen = torch.Generator(device=dev).manual_seed(2)
    t = torch.tensor([0.1], device=dev)
    drop = tband.DropSpec(k0=-1640531527, k1=12345, thresh=tband.drop_thresh(0.3))
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        x = g.x.to(dtype).contiguous()
        packed, _ = tband.softmax_table(x, t, 1e-7)  # the forward's [N_pad, 256] table
        q = torch.randn(g.num_nodes_padded, 128, device=dev, generator=gen).to(dtype)
        e3 = 0.0
        for name, table, band, spec, swap in (
                ("packed fwd table", packed, g.band.fwd, None, False),
                ("[N_pad,128] bwd band", q, g.band.bwd, None, False),
                ("packed fwd table, drop", packed, g.band.fwd, drop, False),
                ("[N_pad,128] bwd band, drop swap", q, g.band.bwd, drop, True)):
            got = tband.band_call(table, band, spec, swap)
            want = tband.band_call_plain(table, band, spec, swap)
            e3 = max(e3, chk.close(f"K3 {name} {tag}", got, want, **tol))
            del got, want
        tol_o = TOL_F32 if dtype == torch.float32 else TOL_BAND_BF16
        tol_b = TOL_F32 if dtype == torch.float32 else TOL_BWD_BF16
        for fn in ("band_spmm", "softmax_sg", "learn_t"):
            res = []
            for plain in (False, True):
                xx = x.detach().clone().requires_grad_(True)
                tt = t.clone().requires_grad_(fn == "learn_t")
                if fn == "band_spmm":
                    o = (tband.band_spmm_plain if plain else tband.band_spmm)(xx, g.band)
                else:
                    f = tband.band_softmax_agg_plain if plain else tband.band_softmax_agg
                    o = f(xx, g.band, tt, 1e-7, fn == "learn_t")
                (o.float() ** 2).sum().backward()
                res.append((o.detach(), xx.grad, tt.grad))
            chk.close(f"{fn} out {tag}", res[0][0], res[1][0], **tol_o)
            chk.close(f"{fn} dx {tag}", res[0][1], res[1][1], **tol_b)
            if fn == "learn_t":
                chk.close(f"{fn} dt {tag}", res[0][2], res[1][2], **TOL_DT[tag])
            del res
        errs[tag] = e3
        del x, packed, q
    sync(dev)
    chk.raise_if_failed()
    return errs


def phase_band_timing(g, errs, launches, iters):
    """K3 in bf16 on the packed forward table of the main path."""
    dev = g.senders.device
    chk = Checks("band timing")
    band = g.band.fwd
    n_pad, w = band.a.shape
    x = g.x.to(torch.bfloat16).contiguous()
    p, _ = tband.softmax_table(x, torch.tensor([0.1], device=dev), 1e-7)
    c = p.shape[1]
    k3_ms = time_fn(lambda: tband.band_call(p, band), dev, iters)
    k3_plain = time_fn(lambda: tband.band_call_plain(p, band), dev, 3)
    # yardstick (never called by the port): the in-band adjacency as one CSR
    # matrix [N_pad, N_pad] of the counts, built once, times the same table.
    # The CPU rehearsal runs it in float32: the CPU's sparse product has no
    # bfloat16.
    py = p if dev.type == "cuda" else p.float()
    nz = torch.nonzero(band.a)
    rows, cols = nz[:, 0], nz[:, 1]
    src = band.w_lo.long()[rows // tband.BN] + cols
    crow = torch.zeros(n_pad + 1, dtype=torch.long, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n_pad), 0)
    a_csr = torch.sparse_csr_tensor(crow, src, band.a[rows, cols].to(py.dtype),
                                    (n_pad, n_pad), check_invariants=True)
    lib_ms = time_fn(lambda: torch.sparse.mm(a_csr, py), dev, iters)
    chk.close("library yardstick sparse.mm vs K3", torch.sparse.mm(a_csr, py),
              tband.band_call(p, band), **TOL_LIBRARY)
    chk.raise_if_failed()
    nnz = int(rows.shape[0])
    # K3: A read once (int8), the table read once and out written once (bf16),
    # w_lo; one f32 multiply-add per (non-zero count, channel)
    k3_bound = bound(n_pad * w + 2 * n_pad * c * 2 + 4 * (n_pad // tband.BN), 2 * nnz * c)
    dense_ms = 2 * n_pad * w * c / BF16_TENSOR_FLOP_PER_S * 1e3
    log(f"[band-timing] K3 {k3_ms:.4f} ms, plain {k3_plain:.3f} ms, sparse.mm {lib_ms:.4f} "
        f"ms, bound {k3_bound[0]:.4f} ms ({k3_bound[1]}); A {n_pad}x{w} with {nnz} "
        f"non-zero counts ({100 * nnz / (n_pad * w):.2f}%); the dense product "
        f"2*N_pad*W*C at the bf16 tensor peak would take {dense_ms:.4f} ms (information)")
    return {"name": "K3 band", "route": "cuda", "source": f"{PKG}/csrc/band.cu",
            "replaces": "deep_gcns_torch_tpu/ops/band.py:425",
            "launches": launches["K3"], "max_abs_err": errs["bf16"], "ms": k3_ms,
            "plain_ms": k3_plain, "bound_ms": k3_bound[0], "bound_by": k3_bound[1],
            "library_ms": lib_ms}


def cluster_graph(n, deg, dev):
    """One ogbn-proteins cluster at `bench.py:221-231`'s shape: uniform random
    edges without added self-loops, 8-dim edge features in both edge orders,
    a species one-hot, 8 node features and 112 binary tasks, from seed 0.
    Returns the graph on ``dev`` and (species, node_feats, labels)."""
    t0 = time.time()
    rng = np.random.default_rng(0)
    g, _ = random_node_graph(rng, n, deg, 8, edge_dim=8, self_loops=False)
    n_pad = g.num_nodes_padded
    species = np.zeros((n_pad, 8), np.float32)
    species[np.arange(n), rng.integers(0, 8, n)] = 1.0
    node_feats = np.zeros((n_pad, 8), np.float32)
    node_feats[:n] = rng.standard_normal((n, 8))
    labels = np.zeros((n_pad, 112), np.float32)
    labels[:n] = rng.integers(0, 2, (n, 112))
    log(f"[cluster-graph] N={g.n_node} E={g.n_edge} N_pad={n_pad} "
        f"E_pad={g.num_edges_padded} built in {time.time() - t0:.1f}s")
    return g.to(dev), tuple(torch.from_numpy(a).to(dev) for a in (species, node_feats, labels))


def edge_inputs(g, c, dtype, gen):
    """x [N_pad, C] and edge embeddings in both edge orders as an edge encoder
    makes them: Linear(8, C) of the raw features, so the padded rows carry
    the bias."""
    dev = g.senders.device
    x = torch.randn(g.num_nodes_padded, c, device=dev, generator=gen).to(dtype)
    w = torch.randn(8, c, device=dev, generator=gen) * 0.5
    b = torch.randn(c, device=dev, generator=gen) * 0.1
    return x, (g.edge_attr @ w + b).to(dtype), (g.edge_attr_csc @ w + b).to(dtype)


def phase_edge_kernels(g):
    """K2 with `ee` and K4 against their plain versions, and the fused
    Function with edge embeddings forward and backward on the kernels
    against the same Function on the plain versions."""
    dev = g.senders.device
    chk = Checks("edge kernels")
    gen = torch.Generator(device=dev).manual_seed(3)
    t = torch.tensor([1.0], device=dev)
    n_pad, n_edge = g.num_nodes_padded, g.n_edge
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        e2 = e4 = 0.0
        for c in (40, 64):
            x, ee, ee_csc = edge_inputs(g, c, dtype, gen)
            out, lse = tsp.softmax_agg(x, g.senders, g.row_ptr, g.row_order, t, 1e-7, ee)
            out_p, lse_p = tsp.softmax_agg_plain(x, g.senders, g.row_ptr, g.row_order, t, 1e-7, ee)
            e2 = max(e2, chk.close(f"K2 ee out C={c} {tag}", out, out_p, **tol),
                     chk.close(f"K2 ee lse C={c} {tag}", lse, lse_p, **TOL_LSE))
            out2, lse2 = tsp.softmax_agg(x, g.senders, g.row_ptr, g.row_order, t, 1e-7, ee)
            chk.equal(f"K2 ee C={c} {tag} two launches bit for bit (out)", out2, out)
            chk.equal(f"K2 ee C={c} {tag} two launches bit for bit (lse)", lse2, lse)
            del out2, lse2
            q = torch.randn(n_pad, c, device=dev, generator=gen).to(dtype)
            for gw in (False, True):
                qo = torch.cat([q, out_p], 1).contiguous() if gw else q
                args = (x, ee_csc, qo, lse_p, g.csc_col_ptr, g.csc_order, g.csc_receivers, t,
                        1e-7, gw)
                dx, dee, dt = tsp.softmax_bwd_csc(*args)
                dx_p, dee_p, dt_p = tsp.softmax_bwd_csc_plain(*args)
                name = f"K4 {'dt' if gw else 'no-dt'} C={c} {tag}"
                e4 = max(e4, chk.close(f"{name} dx", dx, dx_p, **tol),
                         chk.close(f"{name} dee", dee, dee_p, **tol))
                chk.close(f"{name} dee padding rows", dee[n_edge:], dee_p[n_edge:], 0.0, 0.0)
                dx2, dee2, dt2 = tsp.softmax_bwd_csc(*args)
                chk.equal(f"{name} two launches bit for bit (dx)", dx2, dx)
                chk.equal(f"{name} two launches bit for bit (dee)", dee2, dee)
                if gw:
                    # the same float32 terms summed in another order
                    chk.close(f"{name} dt", dt, dt_p, **TOL_DT["f32"])
                    chk.equal(f"{name} two launches bit for bit (dt)", dt2, dt)
                del dx2, dee2
            co = torch.randn(n_pad, c, device=dev, generator=gen)
            for gw in (False, True):
                res = []
                for fn in (tsp.fused_softmax_gather_agg, tsp.fused_softmax_gather_agg_plain):
                    xx = x.detach().clone().requires_grad_(True)
                    ec = ee_csc.detach().clone().requires_grad_(True)
                    tt = t.clone().requires_grad_(gw)
                    o = fn(xx, g.senders, g.row_ptr, g.row_order, g.csc_receivers,
                           g.csc_col_ptr, g.csc_order, tt, ee=ee, ee_csc=ec, eps=1e-7,
                           grad_weights=gw)
                    (o.float() * co).sum().backward()
                    res.append((o.detach(), xx.grad, ec.grad, tt.grad))
                tol_b = (TOL_F32 if dtype == torch.float32 else
                         TOL_EE_LEARN_T_BF16 if gw else TOL_BWD_BF16)
                name = f"fused ee {'learn_t' if gw else 'softmax_sg'} C={c} {tag}"
                chk.close(f"{name} out", res[0][0], res[1][0], **tol)
                chk.close(f"{name} dx", res[0][1], res[1][1], **tol_b)
                chk.close(f"{name} d(ee_csc)", res[0][2], res[1][2], **tol_b)
                if gw:
                    chk.close(f"{name} dt", res[0][3], res[1][3], **TOL_DT[tag])
                del res
        errs[tag] = {"K2 ee": e2, "K4": e4}
    corner = k2_corner_graph(dev)
    k2_corner_checks(chk, corner, True, gen)
    fused_split_checks(chk, corner, True, gen)
    k4_corner_checks(chk, corner, gen)
    sync(dev)
    chk.raise_if_failed()
    return errs


def small_proteins_models():
    """(name, constructor) of a small RevGCN (the main path's config: group 2,
    softmax at a fixed t, layer norm, conv edge encoders) and a small
    DyResGEN (learned t, per-layer edge encoders), both at dropout 0."""
    return (
        ("RevGCN", lambda gen: RevGCN(RevGCNConfig(
            hidden_channels=32, num_tasks=12, num_layers=3, group=2, aggr="softmax",
            dropout=0.0), generator=gen)),
        ("DyResGEN", lambda gen: DeeperGCN(DeeperGCNConfig(
            in_channels=8, hidden_channels=32, num_tasks=12, num_layers=4, block="res+",
            aggr="softmax", learn_t=True, norm="layer", mlp_layers=1, dropout=0.0,
            edge_mode="per_layer", edge_feat_dim=8, use_one_hot_encoding=True,
            node_feat_dim=8, final_dropout=False), generator=gen)))


def phase_edge_agreement(dev):
    """The small proteins models on ``dev`` (K2 with `ee`, K4) against the
    same weights on the CPU (plain versions), in float32."""
    chk = Checks("edge agreement")
    rng = np.random.default_rng(4)
    n, e = 3000, 30000
    g = build_graph(None, rng.integers(0, n, e), rng.integers(0, n, e),
                    edge_attr=rng.random((e, 8)).astype(np.float32), num_nodes=n)
    n_pad = g.num_nodes_padded
    species = torch.from_numpy(np.eye(8, dtype=np.float32)[rng.integers(0, 8, n_pad)])
    nf = torch.from_numpy(rng.standard_normal((n_pad, 8)).astype(np.float32))
    co = torch.from_numpy(rng.standard_normal((n_pad, 12)).astype(np.float32))
    for name, make in small_proteins_models():
        outs = []
        for d in (dev, torch.device("cpu")):
            model = make(torch.Generator().manual_seed(0)).to(d)
            model.train()
            logits = model(species.to(d), g.to(d), node_feats=nf.to(d))
            (logits * co.to(d)).sum().backward()
            outs.append((logits.detach().cpu(),
                         {k: p.grad.detach().cpu() for k, p in model.named_parameters()}))
        # float32 through a few layers: summation order in K2/K4, the norms
        # and the matmuls, as in the DeeperGCN agreement phase
        chk.close(f"small {name} logits, card vs cpu", outs[0][0], outs[1][0], 1e-4, 1e-4)
        g_max = max(float(v.abs().max()) for v in outs[1][1].values())
        for k in outs[1][1]:
            chk.close(f"small {name} grad {k}", outs[0][1][k], outs[1][1][k], 1e-3, 1e-4,
                      ref_max=g_max)
    chk.raise_if_failed()


def free_memory(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        return torch.cuda.memory_allocated(dev)
    return 0


def phase_proteins_path(app, argv, g, feats, steps, expected, tag):
    """A proteins model built by ``app.build_model`` from the app's own flags,
    trained through ``app.train_step`` (one warm-up, ``steps`` timed) and
    run through ``app.predict`` once, with the launch counts set to 0 just
    before and read just after. ``expected(layers, train_steps)`` gives the
    counts a card run must show. Returns (info, a closure of one more train
    step)."""
    dev = g.senders.device
    t_phase = time.time()
    species, node_feats, labels = feats
    args = app.get_args(argv + ["--device", dev.type])
    base = free_memory(dev)
    t0 = time.time()
    model = app.build_model(args, torch.Generator().manual_seed(0)).to(dev)
    opt = make_optimizer("adam", model.parameters(), args.lr)
    build_s = time.time() - t0
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device=dev).manual_seed(1)
    mask = g.node_mask

    def step():
        return app.train_step(model, opt, g, species, node_feats, labels, mask, gen)

    reset_launches()
    losses, times = [float(step())], []  # the warm-up
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = step()
        sync(dev)
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    t0 = time.perf_counter()
    logits = app.predict(model, g, species, node_feats)
    sync(dev)
    predict_s = time.perf_counter() - t0
    launches = read_launches()

    log(f"[{tag}] losses {losses}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{tag}: loss is not finite")
    if logits.shape != (g.num_nodes_padded, 112) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{tag}: predict gave shape {tuple(logits.shape)} or "
                             "non-finite logits")
    want = expected(args.num_layers, steps + 1) if dev.type == "cuda" else no_launches()
    log(f"[{tag}] launches {launches} expected {want}")
    if launches != want:
        raise AssertionError(f"{tag}: kernel launches {launches} != expected {want}")
    info = {"layers": args.num_layers, "params": n_params, "model_build_s": build_s,
            "step_ms_median": sorted(times)[len(times) // 2] * 1e3,
            "step_ms_all": [v * 1e3 for v in times], "predict_ms": predict_s * 1e3,
            "losses": losses, "launches": launches, "phase_s": time.time() - t_phase}
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        info.update(peak_bytes=peak, peak_above_start_bytes=peak - base,
                    smi_after_steps=smi("clocks.sm,power.draw,temperature.gpu"))
    log(f"[{tag}] {json.dumps(info)}")
    return info, step


def rev_expected(group):
    """RevGCN: each train step runs every group's aggregation once in the
    forward and once in the backward's fused inverse+VJP (K2 with `ee`),
    plus its K4; `predict` runs the forward once. An inverse that re-ran
    the forward would show 3·L·G K2 launches a step."""
    def want(layers, n):
        lg = layers * group
        out = no_launches()
        out.update({"K2 ee": 2 * lg * n + lg, "K4": lg * n})
        return out
    return want


def dyresgen_expected(layers, n):
    out = no_launches()
    out.update({"K2 ee": layers * (n + 1), "K4": layers * n})
    return out


def phase_rev_paths(g, feats, depths, steps):
    """RevGCN at the two depths (80 channels, group 2, bf16) with ``steps[i]``
    timed steps at ``depths[i]``, a profile of a step at the smaller one, and
    the O(1)-memory check between them."""
    dev = g.senders.device
    infos = {}
    for layers, n_steps in zip(depths, steps):
        argv = ["--num_layers", str(layers), "--compute_dtype", "bfloat16"]
        info, step = phase_proteins_path(ogbn_proteins_rev, argv, g, feats, n_steps,
                                         rev_expected(2), f"revgcn-{layers}")
        infos[layers] = info
        if layers == depths[0]:
            phase_profile(dev, step, tag=f"revgcn-{layers}-profile")
        del step
    lo, hi = (infos[d] for d in depths)
    if dev.type != "cuda":
        log("[revgcn-memory] no device memory to measure on the CPU")
        return infos
    allowed = 16 * (hi["params"] - lo["params"]) + MEMORY_SLACK_BYTES
    growth = hi["peak_above_start_bytes"] - lo["peak_above_start_bytes"]
    log(f"[revgcn-memory] peak L={depths[0]} {lo['peak_bytes'] / 1e9:.4f} GB, "
        f"L={depths[1]} {hi['peak_bytes'] / 1e9:.4f} GB (ratio "
        f"{hi['peak_bytes'] / lo['peak_bytes']:.4f}); growth above the start "
        f"{growth / 1e6:.1f} MB, allowed {allowed / 1e6:.1f} MB (16 B x "
        f"{hi['params'] - lo['params']} more parameters + 256 MB)")
    if growth > allowed:
        raise AssertionError(f"revgcn-memory: the peak grew by {growth} bytes from "
                             f"L={depths[0]} to L={depths[1]}, more than {allowed}")
    return infos


def phase_proteins_app(dev, argv):
    """`apps/ogbn_proteins_rev.main` for one epoch: the synthetic data, the
    per-epoch partition on the host, ten cluster steps, the 5-part
    evaluation with `scatter_predictions` and ROC-AUC."""
    reset_launches()
    t0 = time.time()
    res = ogbn_proteins_rev.main(argv + ["--device", dev.type])
    wall = time.time() - t0
    launches = read_launches()
    info = {"loss": res["loss"], "results": res["results"],
            "partition_s": res["partition_s"], "wall_s": wall, "launches": launches}
    log(f"[app] {json.dumps(info)}")
    if not math.isfinite(res["loss"]) or not all(
            0.0 <= v <= 1.0 for v in res["results"].values()):
        raise AssertionError(f"app: loss {res['loss']} or ROC-AUC {res['results']} "
                             "out of range")
    if dev.type == "cuda" and (launches["K2 ee"] == 0 or launches["K4"] == 0):
        raise AssertionError(f"app: the edge kernels did not run: {launches}")


def phase_edge_timing(g, errs, launches, iters):
    """K2 with `ee` and K4 in bf16 at C=40 (a RevGCN group) on the cluster
    graph; K4 with dt at C=64 (DyResGEN) for information."""
    dev = g.senders.device
    gen = torch.Generator(device=dev).manual_seed(5)
    n_pad, e, e_pad = g.num_nodes_padded, g.n_edge, g.num_edges_padded
    t = torch.tensor([1.0], device=dev)
    rows, times = [], {}
    for c in (40, 64):
        x, ee, ee_csc = edge_inputs(g, c, torch.bfloat16, gen)
        qo = torch.randn(n_pad, c, device=dev, generator=gen).to(torch.bfloat16)
        out, lse = tsp.softmax_agg(x, g.senders, g.row_ptr, g.row_order, t, 1e-7, ee)
        qo2 = torch.cat([qo, out], 1).contiguous()
        k2 = (lambda: tsp.softmax_agg(x, g.senders, g.row_ptr, g.row_order, t, 1e-7, ee),
              lambda: tsp.softmax_agg_plain(x, g.senders, g.row_ptr, g.row_order, t, 1e-7, ee))
        k4 = [(lambda q=q, gw=gw: tsp.softmax_bwd_csc(
                   x, ee_csc, q, lse, g.csc_col_ptr, g.csc_order, g.csc_receivers, t, 1e-7, gw),
               lambda q=q, gw=gw: tsp.softmax_bwd_csc_plain(
                   x, ee_csc, q, lse, g.csc_col_ptr, g.csc_order, g.csc_receivers, t, 1e-7, gw))
              for q, gw in ((qo, False), (qo2, True))]
        for name, (fn, plain) in (("K2 ee", k2), ("K4", k4[0]), ("K4 dt", k4[1])):
            times[(name, c)] = (time_fn(fn, dev, iters), time_fn(plain, dev, 3))
        del x, ee, ee_csc, qo, qo2, out, lse
    for (name, c), (ms, plain_ms) in times.items():
        log(f"[edge-timing] {name} C={c} bf16: {ms:.4f} ms, plain {plain_ms:.3f} ms")
    c = 40
    idx_b = 4 * e + 4 * (n_pad + 1) + 4
    # K2 with ee: x and ee read once, out (bf16) and lse (float32) written
    # once, the senders, row_ptr and t; per (edge, channel): the first walk's
    # add, max, add, mul and max, then add, max, add, mul, sub, exp, mul, 2
    # roundings, 2 adds
    k2_bound = bound(n_pad * c * 2 + e * c * 2 + idx_b + n_pad * c * 2 + n_pad * c * 4,
                     15 * e * c, e * c)
    # K4: x, ee_csc, qo (bf16) and lse (float32) read once, dx and dee (all
    # E_pad rows) written once; per (edge, channel): add, max, add, mul, sub,
    # exp, mul, select, rounding, add
    k4_bound = bound(n_pad * c * 2 + e * c * 2 + n_pad * c * 2 + n_pad * c * 4 + idx_b
                     + n_pad * c * 2 + e_pad * c * 2, 10 * e * c)
    for name, src, line, b, key in (
            ("K2 softmax_agg ee", "softmax_agg.cu", "deep_gcns_torch_tpu/ops/spmm_pallas.py:322",
             k2_bound, "K2 ee"),
            ("K4 softmax_bwd_csc", "softmax_bwd_csc.cu",
             "deep_gcns_torch_tpu/ops/spmm_pallas.py:466", k4_bound, "K4")):
        ms, plain_ms = times[(key, c)]
        rows.append({"name": name, "route": "cuda", "source": f"{PKG}/csrc/{src}",
                     "replaces": line, "launches": launches[key],
                     "max_abs_err": errs["bf16"][key], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b[0], "bound_by": b[1], "library_ms": None})
        log(f"[edge-timing] {name} C={c}: {ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}); "
            f"card: {CARD}")
    # K4 with dt at C=64 (DyResGEN): as K4 at C=40, with q = [qo | out]
    # read at twice the width and one float32 dt partial a sender row
    # written; per (edge, channel) 3 more operations for dt's term
    c = 64
    k4dt_bound = bound(n_pad * c * 2 + e * c * 2 + n_pad * 2 * c * 2 + n_pad * c * 4 + idx_b
                       + n_pad * c * 2 + e_pad * c * 2 + 4 * n_pad, 13 * e * c)
    log(f"[edge-timing] K4 dt C=64: {times[('K4 dt', c)][0]:.4f} ms, bound "
        f"{k4dt_bound[0]:.4f} ms ({k4dt_bound[1]}); card: {CARD}")
    log("[edge-timing] no single PyTorch call computes K2 with ee or K4: library_ms is null")
    return rows


def revgat_graph(n, dev):
    """The RevGAT-5L graph of `bench.py:420-428`: power-law community edges
    (degree 8, alpha 0.6) made symmetric, with self-loops, cluster order at
    16,384, 128 features and 40 labels from seed 0, and the band ("auto")."""
    rng = np.random.default_rng(0)
    t0 = time.time()
    s, r = powerlaw_community_edges(rng, n, 8, alpha=0.6)
    s, r = to_undirected(s, r)
    s, r = add_self_loops(s, r, n)
    perm = cluster_order(s, r, n, cluster_size=16384)
    s, r = permute_graph(perm, s, r)
    x = rng.standard_normal((n, 128)).astype(np.float32)
    labels = rng.integers(0, 40, n)
    g = build_graph(x, s, r, num_nodes=n)
    t_edges = time.time() - t0
    t0 = time.time()
    g = attach_band(g)
    t_band = time.time() - t0
    g = g.to(dev)
    sync(dev)
    f, b = g.band.fwd, g.band.bwd
    in_deg = np.bincount(r, minlength=n)
    info = {"n": g.n_node, "e": g.n_edge, "n_pad": g.num_nodes_padded,
            "e_pad": g.num_edges_padded, "max_in_degree": int(in_deg.max()),
            "edges_and_order_s": t_edges, "attach_band_s": t_band,
            "window": [f.window, b.window], "coverage": [f.coverage, b.coverage],
            "n_lo": [f.n_lo, b.n_lo], "n_hub": [f.n_hub, b.n_hub],
            "n_hub_row": [f.n_hub_row, b.n_hub_row], "band_device_bytes": g.band.nbytes()}
    log(f"[revgat-graph] (fwd, bwd) {json.dumps(info)}")
    return g, labels


# RevGAT-5L's three packed table widths H·D + H: the first layer (3 x 256),
# a middle group (3 x 128) and the last layer (1 x 40)
GAT_SHAPES = ((3, 256), (3, 128), (1, 40))


def gat_table(g, h, d, dtype, gen):
    """A packed table [msg | el | 0] of the main path's width (H·D + H padded
    to a multiple of 8, as `SymGATConv` builds it), el with a spread of 3."""
    hd = h * d
    p = hd + h + (-(hd + h)) % 8
    t = torch.randn(g.num_nodes_padded, p, device=g.senders.device, generator=gen)
    t[:, hd:hd + h] *= 3.0
    t[:, hd + h:] = 0.0
    return t.to(dtype).contiguous()


def gat_drop(g, drop):
    """(receivers_eff, keep_csc) of the hash edge-drop p=0.3, or none."""
    if not drop:
        return g.receivers, None
    spec = tband.DropSpec(k0=-1640531527, k1=2024, thresh=tband.drop_thresh(0.3))
    keep = tband.edge_keep_mask(spec, g.receivers, g.senders) > 0
    recv = torch.where(keep & g.edge_mask, g.receivers, g.num_nodes_padded)
    return recv, keep.index_select(0, g.csc_perm.long())


def phase_gat_kernels(g):
    """K5 against its plain version and K6 through the Function's backward
    against the Function on the plain versions, at the three widths, in f32
    and bf16, with and without the hash keep."""
    dev = g.senders.device
    chk = Checks("gat kernels")
    gen = torch.Generator(device=dev).manual_seed(6)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        tol_el = TOL_F32 if dtype == torch.float32 else TOL_GAT_EL_BF16
        e5 = e6 = 0.0
        for h, d in GAT_SHAPES:
            hd = h * d
            t = gat_table(g, h, d, dtype, gen)
            co = torch.randn(t.shape, device=dev, generator=gen)
            for drop in (False, True):
                recv, keep_csc = gat_drop(g, drop)
                name = f"{h}x{d} (P={t.shape[1]}){' drop' if drop else ''} {tag}"
                cmax = tsp.gat_cmax(t, hd, h)
                args = (g.senders, recv, g.row_ptr, cmax, hd, h, 0.2)
                e5 = max(e5, chk.close(f"K5 {name}", tsp.gat_fwd(t, *args),
                                       tsp.gat_fwd_plain(t, *args), **tol))
                res = []
                for fn in (tsp.gat_softmax_spmm, tsp.gat_softmax_spmm_plain):
                    tt = t.detach().clone().requires_grad_(True)
                    o = fn(tt, g.senders, recv, g.row_ptr, g.csc_senders, g.csc_receivers,
                           g.csc_col_ptr, keep_csc, hd, h, 0.2)
                    (o.float() * co).sum().backward()
                    res.append(tt.grad)
                    del o, tt
                e6 = max(e6, chk.close(f"K6 dmsg {name}", res[0][:, :hd], res[1][:, :hd],
                                       **tol),
                         chk.close(f"K6 d_el {name}", res[0][:, hd:], res[1][:, hd:],
                                   **tol_el))
                del res
            del t, co
        errs[tag] = {"K5": e5, "K6": e6}
    k5_corner_checks(chk, dev)
    k6_corner_checks(chk, dev)
    sync(dev)
    chk.raise_if_failed()
    return errs


def k5_corner_checks(chk, dev):
    """K5 against its plain version on a 5,000-node graph with a receiver of
    4,500 edges (141 batches of a warp's edge table), 40 receivers whose
    every edge is dropped and 100 with no edge (num, den and the padding
    columns exactly 0), at P=776, 392, 48 (bf16: lane groups) and at D=41
    (P=123, scalar loads), f32 and bf16; two launches bit for bit."""
    n, e = 5000, 40000
    rng = np.random.default_rng(19)
    s, r = rng.integers(0, n, e), rng.integers(0, n - 100, e)
    r[:4500] = 7
    g = build_graph(None, s, r, num_nodes=n).to(dev)
    n_pad = g.num_nodes_padded
    dropped = (g.receivers >= 20) & (g.receivers < 60)
    recv = torch.where(dropped | ~g.edge_mask, n_pad, g.receivers).contiguous()
    gen = torch.Generator(device=dev).manual_seed(3)
    for h, d in GAT_SHAPES + ((2, 41),):
        hd = h * d
        p = hd + h + ((-(hd + h)) % 8 if d % 4 == 0 else 0)
        base = torch.randn(n_pad, p, device=dev, generator=gen)
        base[:, hd:hd + h] *= 3.0
        base[:, hd + h:] = 0.0
        for dtype in (torch.float32, torch.bfloat16):
            tag = "f32" if dtype == torch.float32 else "bf16"
            name = f"corner graph P={p} {tag}"
            t = base.to(dtype).contiguous()
            args = (g.senders, recv, g.row_ptr, tsp.gat_cmax(t, hd, h), hd, h, 0.2)
            out = tsp.gat_fwd(t, *args)
            chk.close(f"K5 {name}", out, tsp.gat_fwd_plain(t, *args),
                      **(TOL_F32 if dtype == torch.float32 else TOL_BF16))
            zero = torch.cat([out[20:60].flatten(), out[n - 100:].flatten(),
                              out[:, hd + h:].flatten()])
            chk.equal(f"K5 rows with every edge dropped or none, and padding, 0 {name}", zero,
                      torch.zeros_like(zero))
            chk.equal(f"K5 two launches bit for bit {name}", tsp.gat_fwd(t, *args), out)


def k6_corner_checks(chk, dev):
    """K6 against its plain version on a 5,000-node graph with a sender of
    4,500 CSC edges (141 batches of a warp's edge table), 40 senders whose
    every edge `keep_csc` drops and 100 with no edge (dT's row, d_el and the
    padding columns exactly 0), at P=776, 392, 48 (bf16: lane groups) and at
    D=41 (P=123, scalar loads), f32 and bf16, with and without `keep_csc`;
    two launches bit for bit."""
    n, e = 5000, 40000
    rng = np.random.default_rng(31)
    s, r = rng.integers(0, n - 100, e), rng.integers(0, n, e)
    s[:4500] = 7
    g = build_graph(None, s, r, num_nodes=n).to(dev)
    n_pad = g.num_nodes_padded
    send = g.csc_senders
    spec = tband.DropSpec(k0=-77, k1=4242, thresh=tband.drop_thresh(0.3))
    hashed = (tband.edge_keep_mask(spec, g.receivers, g.senders) > 0).index_select(
        0, g.csc_perm.long())
    keep_csc = hashed & ~((send >= 20) & (send < 60))
    gen = torch.Generator(device=dev).manual_seed(4)
    for h, d in GAT_SHAPES + ((2, 41),):
        hd = h * d
        p = hd + h + ((-(hd + h)) % 8 if d % 4 == 0 else 0)
        base = torch.randn(n_pad, p, device=dev, generator=gen)
        base[:, hd:hd + h] *= 3.0
        base[:, hd + h:] = 0.0
        q = torch.randn(n_pad, p, device=dev, generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            tag = "f32" if dtype == torch.float32 else "bf16"
            t, qt = base.to(dtype).contiguous(), q.to(dtype).contiguous()
            cmax = tsp.gat_cmax(t, hd, h)
            for keep in (None, keep_csc):
                name = f"corner graph P={p}{' keep' if keep is not None else ''} {tag}"
                args = (g.csc_col_ptr, g.csc_receivers, keep, cmax, hd, h, 0.2)
                dt = tsp.gat_bwd_csc(t, qt, *args)
                want = tsp.gat_bwd_csc_plain(t, qt, *args)
                chk.close(f"K6 dmsg {name}", dt[:, :hd], want[:, :hd],
                          **(TOL_F32 if dtype == torch.float32 else TOL_BF16))
                chk.close(f"K6 d_el {name}", dt[:, hd:], want[:, hd:],
                          **(TOL_F32 if dtype == torch.float32 else TOL_GAT_EL_BF16))
                zero = [dt[n - 100:].flatten(), dt[:, hd + h:].flatten()]
                if keep is not None:
                    zero.append(dt[20:60].flatten())
                zero = torch.cat(zero)
                chk.equal(f"K6 senders with every edge dropped or none, and padding, 0 {name}",
                          zero, torch.zeros_like(zero))
                chk.equal(f"K6 two launches bit for bit {name}", tsp.gat_bwd_csc(t, qt, *args),
                          dt)


def phase_gat_agreement(dev):
    """A small RevGAT (4 layers, 2 heads, group 2, dropout 0, explicit drop
    keys) on the card against the same weights on the CPU, on the CSC route
    (K5/K6) and on the band route (K3/K1)."""
    chk = Checks("gat agreement")
    rng = np.random.default_rng(7)
    n = 3000
    s, r = powerlaw_community_edges(rng, n, 8, alpha=0.6)
    s, r = add_self_loops(*to_undirected(s, r), n)
    s, r = permute_graph(cluster_order(s, r, n, cluster_size=1024), s, r)
    gh = attach_band(build_graph(rng.standard_normal((n, 24)).astype(np.float32), s, r,
                                 num_nodes=n))
    co = torch.from_numpy(rng.standard_normal((gh.num_nodes_padded, 6)).astype(np.float32))
    cfg = RevGATConfig(in_feats=24, n_classes=6, n_hidden=16, n_layers=4, n_heads=2, group=2,
                       dropout=0.0, input_drop=0.0, edge_drop=0.3)
    keys = ((5, -6), [(7, 8), (-9, 10)], (11, 12))
    for route, g in (("csc", gh.replace(band=None)), ("band", gh)):
        outs = []
        for d in (dev, torch.device("cpu")):
            model = RevGAT(cfg, generator=torch.Generator().manual_seed(0)).to(d)
            model.train()
            gd = g.to(d)
            logits = model(gd.x, gd, drop_keys=keys)
            (logits * co.to(d)).sum().backward()
            outs.append((logits.detach().cpu(),
                         {k: p.grad.detach().cpu() for k, p in model.named_parameters()}))
        # float32 through 4 layers, as the other agreement phases
        chk.close(f"small RevGAT {route} logits, card vs cpu", outs[0][0], outs[1][0], 1e-4,
                  1e-4)
        g_max = max(float(v.abs().max()) for v in outs[1][1].values())
        for k in outs[1][1]:
            chk.close(f"small RevGAT {route} grad {k}", outs[0][1][k], outs[1][1][k], 1e-3,
                      1e-4, ref_max=g_max)
    chk.raise_if_failed()


def revgat_expected(g, steps, args, n_steps=None):
    """Launches of (steps + 1) train steps and one `predict` of RevGAT-5L.
    A forward runs 2 + (L−2)·G convs; the backward runs the first and last
    convs' backward and, in the reversible stack, every group conv once more
    forward and once backward. So a step runs 2 + 2·(L−2)·G conv forwards
    and 2 + (L−2)·G backwards, and `predict` (1 + n_label_iters) forwards.
    The CSC route launches K5 per conv forward and K6 per backward; the band
    route K3 per forward and backward, plus K1 wherever that direction's
    leftover is not empty; the dense route (destination scores or the
    per-receiver stabilizer on a band) K7 per forward, K8 and K9 per
    backward, and K1 for the forward band's leftover in the forward and the
    backward (d_er) and for the transpose band's in the backward (d_el,
    d_feat). Every route runs K11 once per block and head norm: a step's
    forward runs (L−2)·G + 1 of them and its recompute (L−2)·G more, the
    backward (L−2)·G + 1, and `predict` (1 + n_label_iters)·((L−2)·G + 1).
    ``n_steps`` overrides steps + 1 (a run without `predict`)."""
    want = no_launches()
    mid = (args.n_layers - 2) * args.group
    step_fwd, step_bwd, predict_fwd = 2 + 2 * mid, 2 + mid, (1 + args.n_label_iters) * (2 + mid)
    log(f"[revgat] a step runs {step_fwd} conv forwards and {step_bwd} backwards, a "
        f"predict {predict_fwd} forwards")
    if g.senders.device.type != "cuda":
        return want
    runs = steps + 1 if n_steps is None else n_steps
    predicts = int(n_steps is None)
    fwd, bwd = step_fwd * runs + predict_fwd * predicts, step_bwd * runs
    want.update({"K11 fwd": (2 * mid + 1) * runs
                 + (1 + args.n_label_iters) * (mid + 1) * predicts,
                 "K11 bwd": (mid + 1) * runs})
    if g.band is None:
        want.update(K5=fwd, K6=bwd)
        return want
    lo_f, lo_b = int(g.band.fwd.n_lo > 0), int(g.band.bwd.n_lo > 0)
    if args.use_attn_dst or args.gat_stabilizer == "per_receiver":
        want.update(K7=fwd, K8=bwd, K9=bwd, K1=fwd * lo_f + bwd * (lo_f + lo_b))
    else:
        want.update(K3=fwd + bwd, K1=fwd * lo_f + bwd * lo_b)
    return want


def phase_revgat_path(g, labels, steps, tag, extra_argv=(), with_predict=True):
    """RevGAT-5L (`bench.py:119-132`: 256 hidden x 3 heads, group 2, in_feats
    128 + 40 label channels, dropout 0.75, input dropout 0.25, edge-drop 0.3,
    sender-only scores, symmetric norm, bf16, RMSprop warming up from lr 0
    to 2e-3 over 50 steps; ``extra_argv`` adds app flags such as
    --use_attn_dst), random weights from seed 0, through the app's
    `train_step` (one warm-up, ``steps`` timed) and, ``with_predict``,
    `predict` (with one label refinement), the launch counts set to 0 just
    before and read just after. Returns (info, a closure of one more train
    step)."""
    dev = g.senders.device
    argv = ["--compute_dtype", "bfloat16", "--device", dev.type, *extra_argv]
    args = ogbn_arxiv_dgl.get_args(argv)
    n, n_pad = g.n_node, g.num_nodes_padded
    base = free_memory(dev)
    lab = torch.zeros(n_pad, dtype=torch.long)
    lab[:n] = torch.from_numpy(np.asarray(labels))
    lab = lab.to(dev)
    onehot = torch.nn.functional.one_hot(lab, 40).float()
    sel = torch.from_numpy(np.random.default_rng(1).random(n_pad) < 0.5).to(dev) & g.node_mask
    feat = ogbn_arxiv_dgl.make_features(g.x, onehot, sel)
    sup = g.node_mask & ~sel
    model = ogbn_arxiv_dgl.build_model(args, 128, torch.Generator().manual_seed(0)).to(dev)
    opt = make_optimizer("rmsprop", model.parameters(), 1.0)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, linear_schedule(0.0, 2e-3, 50))
    gen = torch.Generator(device=dev).manual_seed(1)

    def step():
        return ogbn_arxiv_dgl.train_step(model, opt, sched, g, feat, lab, sup, gen)

    reset_launches()
    loss = step()  # warm-up
    sync(dev)
    losses, times = [float(loss)], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = step()
        sync(dev)
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    predict_s = None
    if with_predict:
        t0 = time.perf_counter()
        logits = ogbn_arxiv_dgl.predict(model, g, g.x, onehot, sel, args.n_label_iters)
        sync(dev)
        predict_s = time.perf_counter() - t0
    launches = read_launches()
    log(f"[{tag}] losses {losses}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{tag}: loss is not finite")
    if with_predict and (logits.shape != (n_pad, 40) or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"{tag}: predict gave shape {tuple(logits.shape)} or "
                             "non-finite logits")
    want = revgat_expected(g, steps, args, None if with_predict else steps + 1)
    log(f"[{tag}] launches {launches} expected {want}")
    if launches != want:
        raise AssertionError(f"{tag}: kernel launches {launches} != expected {want}")
    info = {"params": sum(p.numel() for p in model.parameters()),
            "step_ms_median": sorted(times)[len(times) // 2] * 1e3,
            "step_ms_all": [v * 1e3 for v in times],
            "predict_ms": None if predict_s is None else predict_s * 1e3,
            "losses": losses, "launches": launches}
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        info.update(peak_bytes=peak, peak_above_start_bytes=peak - base,
                    smi_after_steps=smi("clocks.sm,power.draw,temperature.gpu"))
    log(f"[{tag}] {json.dumps(info)}")
    return info, step


def phase_revgat_app(dev, argv):
    """`apps/ogbn_arxiv_dgl.main` for a few epochs on synthetic data: the
    per-epoch label split, RMSprop with its warm-up, `predict` with the
    refinement, accuracies."""
    reset_launches()
    t0 = time.time()
    res = ogbn_arxiv_dgl.main(argv + ["--device", dev.type])
    launches = read_launches()
    info = dict(res, wall_s=time.time() - t0, launches=launches)
    log(f"[revgat-app] {json.dumps(info)}")
    if not math.isfinite(res["loss"]) or not 0.0 <= res["best_valid"] <= 1.0:
        raise AssertionError(f"revgat-app: loss {res['loss']} or accuracy "
                             f"{res['best_valid']} out of range")
    if dev.type == "cuda" and (launches["K5"] == 0 or launches["K6"] == 0):
        raise AssertionError(f"revgat-app: K5/K6 did not run: {launches}")


def phase_gat_timing(g, errs, launches, iters):
    """K5 and K6 in bf16 at the three widths with the hash keep of the
    training step, beside their plain versions and bounds; the row of the
    middle width (6 of a forward's 8 convs) goes into the kernels line."""
    dev = g.senders.device
    gen = torch.Generator(device=dev).manual_seed(8)
    n_pad, e_pad = g.num_nodes_padded, g.num_edges_padded
    recv, keep_csc = gat_drop(g, True)
    kept = int(keep_csc[:g.n_edge].sum()) if keep_csc is not None else g.n_edge
    rows = {}
    for h, d in GAT_SHAPES:
        hd = h * d
        t = gat_table(g, h, d, torch.bfloat16, gen)
        p = t.shape[1]
        q = torch.randn(t.shape, device=dev, generator=gen).to(torch.bfloat16)
        cmax = tsp.gat_cmax(t, hd, h)
        fa = (g.senders, recv, g.row_ptr, cmax, hd, h, 0.2)
        ba = (g.csc_col_ptr, g.csc_receivers, keep_csc, cmax, hd, h, 0.2)
        k5 = (time_fn(lambda: tsp.gat_fwd(t, *fa), dev, iters),
              time_fn(lambda: tsp.gat_fwd_plain(t, *fa), dev, 2))
        k6 = (time_fn(lambda: tsp.gat_bwd_csc(t, q, *ba), dev, iters),
              time_fn(lambda: tsp.gat_bwd_csc_plain(t, q, *ba), dev, 2))
        table = n_pad * p * 2
        # K5: T read once, out written once (bf16), senders and receivers_eff
        # (all E_pad slots), row_ptr, cmax; per kept (edge, column): a
        # multiply, a rounding and an add, and per kept (edge, head) the
        # weight's 5 operations
        b5 = bound(2 * table + 8 * e_pad + 4 * (n_pad + 1) + 4 * h,
                   kept * (3 * hd + 6 * h))
        # K6: T and g read once, dT written once, col_ptr, csc_receivers and
        # the keep bytes; per kept (edge, column): the dot's multiply-add, the
        # weight's multiply, a rounding and an add
        b6 = bound(3 * table + 5 * e_pad + 4 * (n_pad + 1) + 4 * h,
                   kept * (5 * hd + 8 * h))
        # the same if every kept edge's row gather missed L2 and came from HBM
        miss5 = (b5[0] + kept * p * 2 / HBM_BYTES_PER_S * 1e3)
        miss6 = (b6[0] + kept * p * 2 / HBM_BYTES_PER_S * 1e3)
        log(f"[gat-timing] {h}x{d} P={p} bf16, {kept} kept edges: K5 {k5[0]:.4f} ms "
            f"(plain {k5[1]:.3f}), bound {b5[0]:.4f} ms ({b5[1]}), all gathers from HBM "
            f"{miss5:.4f} ms; K6 {k6[0]:.4f} ms (plain {k6[1]:.3f}), bound {b6[0]:.4f} ms "
            f"({b6[1]}), all gathers from HBM {miss6:.4f} ms")
        rows[(h, d)] = (k5, b5, k6, b6)
        if (h, d) == GAT_SHAPES[1] and keep_csc is not None:
            # what the senders of many edges cost: K6 with every edge of a
            # sender of more than 64 CSC edges dropped as well (one warp
            # walks such a row alone)
            deg = (g.csc_col_ptr[1:] - g.csc_col_ptr[:-1]).long()
            edges, senders = tsp._edge_rows(g.csc_col_ptr)
            light = keep_csc.clone()
            light[edges] &= deg[senders] <= 64
            bl = (g.csc_col_ptr, g.csc_receivers, light, cmax, hd, h, 0.2)
            k6_light = time_fn(lambda: tsp.gat_bwd_csc(t, q, *bl), dev, iters)
            log(f"[gat-timing] {h}x{d} P={p} bf16: K6 {k6_light:.4f} ms on the "
                f"{int(light[edges].sum())} kept edges of senders of at most 64 edges (largest "
                f"sender {int(deg.max())} edges), against {k6[0]:.4f} ms on all {kept}")
        del t, q
    log("[gat-timing] no single PyTorch call computes K5 or K6: library_ms is null")
    k5, b5, k6, b6 = rows[GAT_SHAPES[1]]
    return [{"name": "K5 gat_fwd", "route": "cuda", "source": f"{PKG}/csrc/gat_fwd.cu",
             "replaces": "deep_gcns_torch_tpu/ops/spmm_pallas.py:837",
             "launches": launches["K5"], "max_abs_err": errs["bf16"]["K5"], "ms": k5[0],
             "plain_ms": k5[1], "bound_ms": b5[0], "bound_by": b5[1], "library_ms": None},
            {"name": "K6 gat_bwd_csc", "route": "cuda", "source": f"{PKG}/csrc/gat_bwd_csc.cu",
             "replaces": "deep_gcns_torch_tpu/ops/spmm_pallas.py:862",
             "launches": launches["K6"], "max_abs_err": errs["bf16"]["K6"], "ms": k6[0],
             "plain_ms": k6[1], "bound_ms": b6[0], "bound_by": b6[1], "library_ms": None}]


# K11 against its plain halves, float32: Welford/Chan statistics against
# two-pass column sums move μ by float32 roundings of the column mean, so y
# agrees to 1e-5 relative above 1e-5 of max|y|; dw and db are column sums
# over every row in different orders (1e-5 of the sum of their terms'
# magnitudes), and dx, given the same statistics, to 1e-5 above 1e-5 of
# max|dx|
TOL_K11 = dict(rtol=1e-5, atol_rel=1e-5)
# (name, C, strided, form, dropout rate) of phase 71: RevGAT's block in
# training and in evaluation, its head in training and in evaluation, then
# ResGEN-28's res+ prologue (DeeperGCN's BatchNorm) in training, with its
# keep mask and the running update, and in evaluation, on the running
# statistics
K11_CASES = (("block", 384, True, "float", 0.75), ("block eval", 384, True, "none", 0.75),
             ("head", 768, False, "keep", 0.75), ("head eval", 768, False, "none", 0.75),
             ("resgen", 128, False, "running", 0.5), ("resgen eval", 128, False, "eval", 0.5))


def phase_norm_act(dev, rehearse, iters):
    """K11 forward and backward against the plain halves at the cells'
    shapes, two launches bit for bit, and the times of both beside their
    byte bounds and the plain halves' (phase 71); the evaluation form, a
    forward only."""
    n_pad, n_valid = (2_048, 2_000) if rehearse else (169_472, 169_343)
    gen = torch.Generator(device=dev).manual_seed(71)
    chk = Checks("norm-act")
    rows = []
    for name, c, strided, form, rate in K11_CASES:
        wide = torch.randn(n_pad, 2 * c if strided else c, device=dev, generator=gen) * 3 + 20
        x = torch.chunk(wide, 2, dim=-1)[1] if strided else wide
        mask = torch.arange(n_pad, device=dev) < n_valid
        w = torch.rand(c, device=dev, generator=gen) + 0.5
        b = torch.randn(c, device=dev, generator=gen) * 0.5
        keep_all = torch.rand(wide.shape, device=dev, generator=gen) >= rate
        keep_all = torch.chunk(keep_all, 2, dim=-1)[1] if strided else keep_all
        mult = keep_all.float() / (1 - rate) if form == "float" else None
        keep = keep_all if form in ("keep", "running") else None
        if form in ("running", "eval"):
            rm = torch.randn(c, device=dev, generator=gen) * 5 + 20
            rv = torch.rand(c, device=dev, generator=gen) * 4 + 8
        dy = torch.randn(n_pad, c, device=dev, generator=gen)
        label = f"K11 {name} C={c}"
        full = n_pad * c * 4
        m_bytes = {"float": full, "keep": n_pad * c, "running": n_pad * c}.get(form, 0)
        if form == "eval":
            fa = (x, rm, rv, w, b)
            y = tna.batch_norm_act_eval_fwd(*fa)[0]
            chk.close(f"{label} y", y, tna.batch_norm_act_eval_fwd_plain(*fa)[0], **TOL_K11)
            chk.equal(f"{label} two launches bit for bit (y)", tna.batch_norm_act_eval_fwd(*fa)[0],
                      y)
            t_f = device_ms(lambda: tna.batch_norm_act_eval_fwd(*fa), dev, iters)
            p_f = time_fn(lambda: tna.batch_norm_act_eval_fwd_plain(*fa), dev, 5)
            # x read, y written
            b_f = bound(2 * full, 0)[0]
            log(f"[norm-act] {label} (running statistics): forward {t_f:.4f} ms device, bound "
                f"{b_f:.4f} ms ({2 * full / 1e9:.3f} GB), plain {p_f:.3f} ms [{CARD}]")
            rows.append({"name": f"K11 fwd {name} C={c}", "route": "cuda",
                         "source": f"{PKG}/csrc/batch_norm_act.cu", "replaces": None,
                         "ms": t_f, "plain_ms": p_f, "bound_ms": b_f, "bound_by": "bytes",
                         "library_ms": None})
            del wide, x, keep_all, dy, fa, y
            free_memory(dev)
            continue
        fa = (x, mask, w, b, mult, keep, 1 - rate)
        running = (rm.clone(), rv.clone(), 0.1) if form == "running" else None
        y, mu, rstd, cnt = tna.batch_norm_act_fwd(*fa, running=running)
        run_p = (rm.clone(), rv.clone(), 0.1) if form == "running" else None
        y_p = tna.batch_norm_act_fwd_plain(*fa, running=run_p)[0]
        chk.close(f"{label} y", y, y_p, **TOL_K11)
        if running is not None:
            chk.close(f"{label} running_mean", running[0], run_p[0], **TOL_K11)
            chk.close(f"{label} running_var", running[1], run_p[1], **TOL_K11)
        ba = (dy, x, mask, w, b, mult, keep, 1 - rate, mu, rstd, cnt)
        dx, dw, db = tna.batch_norm_act_bwd(*ba)
        dx_p, dw_p, db_p = tna.batch_norm_act_bwd_plain(*ba)
        xh = (x - mu) * rstd
        g = torch.where(xh * w + b > 0, tna._apply_mult(dy, mult, keep, 1 - rate),
                        torch.zeros((), device=dev))
        chk.close(f"{label} dx", dx, dx_p, **TOL_K11)
        for what, got, want, mag in (("db", db, db_p, g.abs().sum(0)),
                                     ("dw", dw, dw_p, (g * xh).abs().sum(0))):
            # each column within 1e-5 of the sum of its terms' magnitudes
            mag = mag + 1e-30
            chk.close(f"{label} {what}", got / mag, want / mag, 0.0, 1e-5, ref_max=1.0)
        y2 = tna.batch_norm_act_fwd(*fa, running=running)[0]
        dx2 = tna.batch_norm_act_bwd(*ba)[0]
        chk.equal(f"{label} two launches bit for bit (y)", y2, y)
        chk.equal(f"{label} two launches bit for bit (dx)", dx2, dx)
        del g, xh, y2, dx2, y_p, dx_p
        t_f = device_ms(lambda: tna.batch_norm_act_fwd(*fa, running=running), dev, iters)
        t_b = device_ms(lambda: tna.batch_norm_act_bwd(*ba), dev, iters)
        p_f = time_fn(lambda: tna.batch_norm_act_fwd_plain(*fa, running=run_p), dev, 5)
        p_b = time_fn(lambda: tna.batch_norm_act_bwd_plain(*ba), dev, 5)
        # forward: x twice (statistics, output pass), mult once, y written;
        # backward: x, dy and mult twice (column sums, dx pass), dx written
        b_f = bound(3 * full + m_bytes, 0)[0]
        b_b = bound(5 * full + 2 * m_bytes, 0)[0]
        log(f"[norm-act] {label}{' (row stride ' + str(2 * c) + ')' if strided else ''}"
            f" mult={form}: forward {t_f:.4f} ms device, bound {b_f:.4f} ms "
            f"({(3 * full + m_bytes) / 1e9:.3f} GB), plain {p_f:.3f} ms; backward {t_b:.4f} ms "
            f"device, bound {b_b:.4f} ms ({(5 * full + 2 * m_bytes) / 1e9:.3f} GB), plain "
            f"{p_b:.3f} ms [{CARD}]")
        for d, t, bd, pl in (("fwd", t_f, b_f, p_f), ("bwd", t_b, b_b, p_b)):
            rows.append({"name": f"K11 {d} {name} C={c}", "route": "cuda",
                         "source": f"{PKG}/csrc/batch_norm_act.cu", "replaces": None,
                         "ms": t, "plain_ms": pl, "bound_ms": bd, "bound_by": "bytes",
                         "library_ms": None})
        del wide, x, keep_all, mult, keep, dy, fa, ba
        free_memory(dev)
    chk.raise_if_failed()
    return rows


# K7–K9 against their plain versions: M is a maximum, equal bit for bit;
# num, den, d_er, d_el and d_feat are float32 sums of terms that kernel and
# plain version compute alike (the same expf, weights rounded to the compute
# type alike), so only the order of the sums differs, and for d_er and d_el
# also the order of each per-head dot product
TOL_DENSE = dict(rtol=1e-5, atol_rel=1e-5)
TOL_DENSE_T = dict(rtol=1e-4, atol_rel=1e-5)
# the dense Function in bf16: the leftover's K1 sums round to bf16, so one ulp
# of a partial sum passes into the result, as on the band route
TOL_DENSE_FN = {"f32": dict(rtol=1e-4, atol_rel=1e-5),
                "bf16": dict(rtol=2.0 ** -5, atol_rel=1e-4)}


def dense_drop(drop):
    """The hash edge-drop p=0.3 of a training step, or none."""
    return tband.DropSpec(k0=-1640531527, k1=2024, thresh=tband.drop_thresh(0.3)) if drop \
        else None


def dense_inputs(g, h, d, dtype, gen):
    """feat [N_pad, H·D] in ``dtype`` and el, er [N_pad, H] float32 with a
    spread of scores, as a conv makes them."""
    n = g.num_nodes_padded
    dev = g.senders.device
    feat = torch.randn(n, h * d, device=dev, generator=gen).to(dtype)
    el = torch.randn(n, h, device=dev, generator=gen) * 2.0
    er = torch.randn(n, h, device=dev, generator=gen) * 2.0
    return feat, el, er


def dense_m_other(band, el, er, spec):
    """The main path's m_other: the maxima of the structures outside K7."""
    return tgd.other_maxima(band, el, er, 0.2, tgd.Keeps(band, spec, False))


def phase_dense_kernels(g):
    """K7 against its plain version (M bit for bit), K8 and K9 directly and
    through the Function's backward against the Function on the plain
    versions, at RevGAT-5L's three head shapes, in f32 and bf16, with and
    without the hash edge-drop, on the RevGAT graph's band."""
    dev = g.senders.device
    chk = Checks("dense kernels")
    gen = torch.Generator(device=dev).manual_seed(9)
    band, bwd = g.band.fwd, g.band.bwd
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        e7 = e8 = e9 = 0.0
        for h, d in GAT_SHAPES:
            feat, el, er = dense_inputs(g, h, d, dtype, gen)
            gnum = torch.randn(feat.shape, device=dev, generator=gen).to(dtype)
            gden = torch.randn(el.shape, device=dev, generator=gen)
            for drop in (False, True):
                spec = dense_drop(drop)
                name = f"{h}x{d}{' drop' if drop else ''} {tag}"
                m_other = dense_m_other(band, el, er, spec)
                num, den, m = tgd.win_fused(band, el, er, m_other, feat, 0.2, spec)
                num_p, den_p, m_p = tgd.win_fused_plain(band, el, er, m_other, feat, 0.2, spec)
                chk.equal(f"K7 M {name}", m, m_p)
                e7 = max(e7, chk.close(f"K7 num {name}", num, num_p, **TOL_DENSE),
                         chk.close(f"K7 den {name}", den, den_p, **TOL_DENSE))
                for part, a, b in zip(("num", "den", "M"), tgd.win_fused(
                        band, el, er, m_other, feat, 0.2, spec), (num, den, m)):
                    chk.equal(f"K7 two launches bit for bit ({part}) {name}", a, b)
                del num, den, m, num_p, den_p
                args = (el, er, m_p, feat, gnum, gden, 0.2, spec)
                e8 = max(e8, chk.close(f"K8 d_er {name}", tgd.win_der(band, *args),
                                       tgd.win_der_plain(band, *args), **TOL_DENSE_T))
                d_el, d_feat = tgd.win_dsend(bwd, *args)
                d_el_p, d_feat_p = tgd.win_dsend_plain(bwd, *args)
                e9 = max(e9, chk.close(f"K9 d_el {name}", d_el, d_el_p, **TOL_DENSE_T),
                         chk.close(f"K9 d_feat {name}", d_feat, d_feat_p, **TOL_DENSE))
                del d_el, d_feat, d_el_p, d_feat_p
                co_n = torch.randn(feat.shape, device=dev, generator=gen).reshape(-1, h, d)
                co_d = torch.randn(el.shape, device=dev, generator=gen)
                res = []
                for fn in (tgd.gat_dense_agg, tgd.gat_dense_agg_plain):
                    f = feat.float().reshape(-1, h, d).requires_grad_(True)
                    l_, r_ = el.clone().requires_grad_(True), er.clone().requires_grad_(True)
                    o_n, o_d = fn(f, l_, r_, None, None, None, g.band, spec, 0.2, dtype)
                    ((o_n * co_n).sum() + (o_d * co_d).sum()).backward()
                    res.append((o_n.detach(), o_d.detach(), f.grad, l_.grad, r_.grad))
                    del o_n, o_d, f, l_, r_
                for part, a, b in zip(("num", "den", "d_feat", "d_el", "d_er"), *res):
                    chk.close(f"Function {part} {name}", a, b, **TOL_DENSE_FN[tag])
                del res, co_n, co_d
            del feat, el, er, gnum, gden
        errs[tag] = {"K7": e7, "K8": e8, "K9": e9}
    long_rows = k7_long_row_band(dev)
    k7_long_row_checks(chk, long_rows)
    for hubs in (True, False):
        k8_long_row_checks(chk, long_rows if hubs else k7_long_row_band(dev, False))
        k9_long_row_checks(chk, k9_long_row_band(dev, hubs))
    sync(dev)
    chk.raise_if_failed()
    return errs


def k7_long_row_band(dev, hubs=True):
    """A band whose rows reach K7's list and pass it: 4,096 locality-banded
    nodes with power-law senders (window 768, no hub rows, so that no row
    leaves the window) where
    receiver 5 takes 700 senders of its window, 300 takes 400 and 700 exactly
    256, with the hub columns of a second band (degree ≥ 64) attached when
    ``hubs``, so that a long row's chunks run on into its hub columns."""
    rng = np.random.default_rng(21)
    n, deg = 4096, 8
    w = (1.0 / (1.0 + np.arange(n, dtype=np.float64))) ** 0.8  # power-law senders
    rng.shuffle(w)
    s = rng.choice(n, n * deg, p=w / w.sum())
    r = np.clip(s + rng.integers(-200, 201, n * deg), 0, n - 1)
    hub_graph = build_graph(None, s, r, num_nodes=n)
    s = np.concatenate([s, np.arange(0, 700), np.arange(100, 500), np.arange(500, 756)])
    r = np.concatenate([r, np.full(700, 5), np.full(400, 300), np.full(256, 700)])
    g = attach_band(build_graph(None, s, r, num_nodes=n), window=768, hubs=None)
    if not hubs:
        return g.band.fwd.to(dev)
    band = attach_band(hub_graph, window=768, hubs=64).band.fwd
    fwd = dataclasses.replace(g.band.fwd, hub_ids=band.hub_ids, a_hub=band.a_hub)
    return fwd.to(dev)


def k7_long_row_checks(chk, band):
    """K7 against its plain version on `k7_long_row_band`, at the three head
    shapes, f32 and bf16, with and without the drop: M bit for bit, num and
    den within TOL_DENSE, two launches bit for bit. Rows past the list are
    done in chunks inside the kernel, never by the plain version."""
    dev = band.a.device
    gen = torch.Generator(device=dev).manual_seed(23)
    n = band.a.shape[0]
    kept = (band.a > 0).sum(1) + (band.a_hub > 0).sum(1)
    for h, d in GAT_SHAPES:
        size = tgd.k7_list_size(h)
        log(f"[dense kernels] long-row band, {h}x{d}: list of {size}, "
            f"{int((kept >= size).sum())} rows with at least as many positions "
            f"(longest {int(kept.max())})")
        if int(kept.max()) < 2 * size:
            raise AssertionError("the long-row band does not pass K7's list")
        for dtype in (torch.float32, torch.bfloat16):
            tag = "f32" if dtype == torch.float32 else "bf16"
            feat = torch.randn(n, h * d, device=dev, generator=gen).to(dtype)
            el = torch.randn(n, h, device=dev, generator=gen) * 2.0
            er = torch.randn(n, h, device=dev, generator=gen) * 2.0
            m_other = torch.full((n, h), tgd.NEG, device=dev)
            m_other[::5] = 3.0
            for drop in (False, True):
                spec = dense_drop(drop)
                name = f"long rows {h}x{d}{' drop' if drop else ''} {tag}"
                num, den, m = tgd.win_fused(band, el, er, m_other, feat, 0.2, spec)
                num_p, den_p, m_p = tgd.win_fused_plain(band, el, er, m_other, feat, 0.2, spec)
                chk.equal(f"K7 M {name}", m, m_p)
                chk.close(f"K7 num {name}", num, num_p, **TOL_DENSE)
                chk.close(f"K7 den {name}", den, den_p, **TOL_DENSE)
                for part, a, b in zip(("num", "den", "M"), tgd.win_fused(
                        band, el, er, m_other, feat, 0.2, spec), (num, den, m)):
                    chk.equal(f"K7 two launches bit for bit ({part}) {name}", a, b)


def k8_long_row_checks(chk, band):
    """K8 against its plain version on `k7_long_row_band` (receiver rows of
    256, 400 and 700 positions, with or without hub columns), at the three
    head shapes and D=41 (scalar loads), f32 and bf16, with and without the
    drop: d_er within TOL_DENSE_T (its per-head dot is regrouped as
    gnum·Σ a·feat), rows with no kept position exactly 0, two launches bit
    for bit. Rows past the list are done in chunks inside the kernel."""
    dev = band.a.device
    gen = torch.Generator(device=dev).manual_seed(37)
    n = band.a.shape[0]
    hubs = band.hub_ids is not None
    kept = (band.a > 0).sum(1) + ((band.a_hub > 0).sum(1) if hubs else 0)
    for h, d in GAT_SHAPES + ((2, 41),):
        size = tgd.k8_list_size(h)
        log(f"[dense kernels] K8 long-row band{'' if hubs else ' without hub columns'}, "
            f"{h}x{d}: list of {size}, {int((kept >= size).sum())} rows with at least as "
            f"many positions (longest {int(kept.max())}), {int((kept == 0).sum())} with none")
        if int(kept.max()) < 2 * size:
            raise AssertionError("the long-row band does not pass K8's list")
        for dtype in (torch.float32, torch.bfloat16):
            tag = "f32" if dtype == torch.float32 else "bf16"
            feat = torch.randn(n, h * d, device=dev, generator=gen).to(dtype)
            gnum = torch.randn(n, h * d, device=dev, generator=gen).to(dtype)
            el = torch.randn(n, h, device=dev, generator=gen) * 2.0
            er = torch.randn(n, h, device=dev, generator=gen) * 2.0
            gden = torch.randn(n, h, device=dev, generator=gen)
            m = torch.full((n, h), 3.0, device=dev)
            m[::3] = 6.0
            for drop in (False, True):
                spec = dense_drop(drop)
                name = (f"long receiver rows{'' if hubs else ', no hub columns'} {h}x{d}"
                        f"{' drop' if drop else ''} {tag}")
                args = (el, er, m, feat, gnum, gden, 0.2, spec)
                d_er = tgd.win_der(band, *args)
                chk.close(f"K8 d_er {name}", d_er, tgd.win_der_plain(band, *args),
                          **TOL_DENSE_T)
                empty = torch.ones(n, dtype=torch.bool, device=dev)
                empty[tgd._entries(band, spec, False)[0]] = False
                chk.equal(f"K8 rows with no kept position 0 {name}", d_er[empty],
                          torch.zeros_like(d_er[empty]))
                chk.equal(f"K8 two launches bit for bit {name}", tgd.win_der(band, *args), d_er)


def k9_long_row_band(dev, hubs):
    """The mirror of `k7_long_row_band` for K9: a TRANSPOSE band whose sender
    rows reach and pass K9's list (sender 5 sends to 700 receivers of its
    window, 300 to 400 and 700 to exactly 256; window 768, no hub rows), with
    the transpose hub columns of a second band (degree ≥ 64) attached when
    ``hubs``. The power-law senders leave many rows with no position."""
    rng = np.random.default_rng(21)
    n, deg = 4096, 8
    w = (1.0 / (1.0 + np.arange(n, dtype=np.float64))) ** 0.8
    rng.shuffle(w)
    s = rng.choice(n, n * deg, p=w / w.sum())
    r = np.clip(s + rng.integers(-200, 201, n * deg), 0, n - 1)
    hub_band = attach_band(build_graph(None, s, r, num_nodes=n), window=768, hubs=64).band.bwd
    s = np.concatenate([s, np.full(700, 5), np.full(400, 300), np.full(256, 700)])
    r = np.concatenate([r, np.arange(0, 700), np.arange(100, 500), np.arange(500, 756)])
    band = attach_band(build_graph(None, s, r, num_nodes=n), window=768, hubs=None).band.bwd
    if hubs:
        band = dataclasses.replace(band, hub_ids=hub_band.hub_ids, a_hub=hub_band.a_hub)
    return band.to(dev)


def k9_long_row_checks(chk, band):
    """K9 against its plain version on `k9_long_row_band`, at the three head
    shapes and D=41 (scalar loads), f32 and bf16, with and without the drop:
    d_el within TOL_DENSE_T, d_feat within TOL_DENSE, rows with no kept
    position exactly 0, two launches bit for bit. Rows past the list are done
    in chunks inside the kernel."""
    dev = band.a.device
    gen = torch.Generator(device=dev).manual_seed(29)
    n = band.a.shape[0]
    hubs = band.hub_ids is not None
    kept = (band.a > 0).sum(1) + ((band.a_hub > 0).sum(1) if hubs else 0)
    for h, d in GAT_SHAPES + ((2, 41),):
        size = tgd.k9_list_size(h)
        log(f"[dense kernels] K9 long-row band{'' if hubs else ' without hub columns'}, "
            f"{h}x{d}: list of {size}, {int((kept >= size).sum())} rows with at least as "
            f"many positions (longest {int(kept.max())}), {int((kept == 0).sum())} with none")
        if int(kept.max()) < 2 * size:
            raise AssertionError("the long-row band does not pass K9's list")
        for dtype in (torch.float32, torch.bfloat16):
            tag = "f32" if dtype == torch.float32 else "bf16"
            feat = torch.randn(n, h * d, device=dev, generator=gen).to(dtype)
            gnum = torch.randn(n, h * d, device=dev, generator=gen).to(dtype)
            el = torch.randn(n, h, device=dev, generator=gen) * 2.0
            er = torch.randn(n, h, device=dev, generator=gen) * 2.0
            gden = torch.randn(n, h, device=dev, generator=gen)
            m = torch.full((n, h), 3.0, device=dev)
            m[::3] = 6.0
            for drop in (False, True):
                spec = dense_drop(drop)
                name = (f"long sender rows{'' if hubs else ', no hub columns'} {h}x{d}"
                        f"{' drop' if drop else ''} {tag}")
                args = (el, er, m, feat, gnum, gden, 0.2, spec)
                d_el, d_feat = tgd.win_dsend(band, *args)
                d_el_p, d_feat_p = tgd.win_dsend_plain(band, *args)
                chk.close(f"K9 d_el {name}", d_el, d_el_p, **TOL_DENSE_T)
                chk.close(f"K9 d_feat {name}", d_feat, d_feat_p, **TOL_DENSE)
                empty = torch.ones(n, dtype=torch.bool, device=dev)
                empty[tgd._entries(band, spec, True)[0]] = False
                zero = torch.cat([d_el[empty].flatten(), d_feat[empty].flatten()])
                chk.equal(f"K9 rows with no kept position 0 {name}", zero,
                          torch.zeros_like(zero))
                for part, a, b in zip(("d_el", "d_feat"), tgd.win_dsend(band, *args),
                                      (d_el, d_feat)):
                    chk.equal(f"K9 two launches bit for bit ({part}) {name}", a, b)


def phase_dense_agreement(dev):
    """A small RevGAT with destination scores and one with the per-receiver
    stabilizer (4 layers, 2 heads, group 2, dropout 0, explicit drop keys),
    and a small PyG GATConv on a graph with explicit self edges, on a band's
    dense route on the card (K7–K9, K1) against the same weights on the CPU
    (plain versions): logits (outputs) and every gradient, float32."""
    chk = Checks("dense agreement")
    rng = np.random.default_rng(10)
    n = 3000
    s, r = powerlaw_community_edges(rng, n, 8, alpha=0.6)
    s, r = add_self_loops(*to_undirected(s, r), n)
    s, r = permute_graph(cluster_order(s, r, n, cluster_size=1024), s, r)
    gh = attach_band(build_graph(rng.standard_normal((n, 24)).astype(np.float32), s, r,
                                 num_nodes=n))
    co = torch.from_numpy(rng.standard_normal((gh.num_nodes_padded, 6)).astype(np.float32))
    keys = ((5, -6), [(7, 8), (-9, 10)], (11, 12))
    runs = []
    for name, kw in (("attn_dst", dict(use_attn_dst=True)),
                     ("per_receiver", dict(stabilizer="per_receiver"))):
        cfg = RevGATConfig(in_feats=24, n_classes=6, n_hidden=16, n_layers=4, n_heads=2,
                           group=2, dropout=0.0, input_drop=0.0, edge_drop=0.3, **kw)

        def run(d, cfg=cfg):
            model = RevGAT(cfg, generator=torch.Generator().manual_seed(0)).to(d)
            model.train()
            gd = gh.to(d)
            logits = model(gd.x, gd, drop_keys=keys)
            (logits * co.to(d)).sum().backward()
            return logits.detach().cpu(), {k: p.grad.detach().cpu()
                                           for k, p in model.named_parameters()}
        runs.append((f"small RevGAT {name}", run))
    # PyG's GATConv with explicit self edges (already in the graph) and the
    # analytic self term
    co_p = torch.from_numpy(rng.standard_normal((gh.num_nodes_padded, 32)).astype(np.float32))

    def run_pyg(d):
        conv = GATConv(24, 8, heads=4, generator=torch.Generator().manual_seed(1)).to(d)
        gd = gh.to(d)
        x = gd.x.clone().requires_grad_(True)
        out = conv(x, gd)
        (out * co_p.to(d)).sum().backward()
        grads = {k: p.grad.detach().cpu() for k, p in conv.named_parameters()}
        grads["x"] = x.grad.cpu()
        return out.detach().cpu(), grads
    runs.append(("small PyG GATConv", run_pyg))
    for name, run in runs:
        got, want = run(dev), run(torch.device("cpu"))
        # float32 through 4 layers, as the other agreement phases
        chk.close(f"{name} outputs, card vs cpu", got[0], want[0], 1e-4, 1e-4)
        g_max = max(float(v.abs().max()) for v in want[1].values())
        for k in want[1]:
            chk.close(f"{name} grad {k}", got[1][k], want[1][k], 1e-3, 1e-4, ref_max=g_max)
    chk.raise_if_failed()


def phase_dense_timing(g, errs, launches, iters):
    """K7, K8 and K9 in bf16 at the three head shapes with the training
    step's hash drop, beside their plain versions and bounds; the rows of the
    middle shape (6 of a forward's 8 convs) go into the kernels line."""
    dev = g.senders.device
    gen = torch.Generator(device=dev).manual_seed(11)
    band, bwd = g.band.fwd, g.band.bwd
    spec = dense_drop(True)
    n = g.num_nodes_padded
    small = 4 * n  # one float32 [N_pad] column

    def struct_bytes(b):
        hub = 0 if b.hub_ids is None else b.a_hub.numel() * 2 + b.hub_ids.numel() * 4
        return b.a.numel() + b.w_lo.numel() * 4 + hub

    # valid positions (edges the drop keeps) in each kernel's structures
    valid_f = int(tgd._entries(band, spec, False)[0].shape[0])
    valid_b = int(tgd._entries(bwd, spec, True)[0].shape[0])
    rows = {}
    for h, d in GAT_SHAPES:
        feat, el, er = dense_inputs(g, h, d, torch.bfloat16, gen)
        gnum = torch.randn(feat.shape, device=dev, generator=gen).to(torch.bfloat16)
        gden = torch.randn(el.shape, device=dev, generator=gen)
        m_other = dense_m_other(band, el, er, spec)
        m = tgd.win_fused(band, el, er, m_other, feat, 0.2, spec)[2]
        args = (el, er, m, feat, gnum, gden, 0.2, spec)
        t7 = (time_fn(lambda: tgd.win_fused(band, el, er, m_other, feat, 0.2, spec), dev, iters),
              time_fn(lambda: tgd.win_fused_plain(band, el, er, m_other, feat, 0.2, spec),
                      dev, 2))
        t8 = (time_fn(lambda: tgd.win_der(band, *args), dev, iters),
              time_fn(lambda: tgd.win_der_plain(band, *args), dev, 2))
        t9 = (time_fn(lambda: tgd.win_dsend(bwd, *args), dev, iters),
              time_fn(lambda: tgd.win_dsend_plain(bwd, *args), dev, 2))
        hd2 = n * h * d * 2  # one bf16 [N_pad, H·D] table
        # K7: A, the hub counts, el, er, m_other and feat read once, num
        # (float32), den and M written once; per valid (position, head) the
        # two score walks and the weight (~11 operations) and 2·D for num
        b7 = bound(struct_bytes(band) + 3 * h * small + hd2 + 2 * hd2 + 2 * h * small,
                   valid_f * h * (11 + 2 * d))
        # K8: A, hub counts, el, er, M, gden, feat and gnum read once, d_er
        # written; per valid (position, head) ~10 operations and the 2·D dot
        b8 = bound(struct_bytes(band) + 4 * h * small + 2 * hd2 + h * small,
                   valid_f * h * (10 + 2 * d))
        # K9: the transpose band's structures, el, er, M, gden, feat and gnum
        # read once, d_el and d_feat (float32) written; per valid (position,
        # head) ~12 operations, the 2·D dot and 2·D for d_feat
        b9 = bound(struct_bytes(bwd) + 4 * h * small + 2 * hd2 + h * small + 2 * hd2,
                   valid_b * h * (12 + 4 * d))
        log(f"[dense-timing] {h}x{d} bf16, {valid_f} / {valid_b} valid positions (fwd / bwd "
            f"band): K7 {t7[0]:.4f} ms (plain {t7[1]:.3f}), bound {b7[0]:.4f} ms ({b7[1]}); "
            f"K8 {t8[0]:.4f} ms (plain {t8[1]:.3f}), bound {b8[0]:.4f} ms ({b8[1]}); K9 "
            f"{t9[0]:.4f} ms (plain {t9[1]:.3f}), bound {b9[0]:.4f} ms ({b9[1]})")
        rows[(h, d)] = ((t7, b7), (t8, b8), (t9, b9))
        del feat, el, er, gnum, gden, m_other, m, args
    log("[dense-timing] no single PyTorch call computes K7, K8 or K9: library_ms is null")
    out = []
    for (name, src, line, key), (t, b) in zip(
            (("K7 win_fused", "win_fused.cu", "deep_gcns_torch_tpu/ops/gat_dense.py:1274", "K7"),
             ("K8 win_der", "win_der.cu", "deep_gcns_torch_tpu/ops/gat_dense.py:966", "K8"),
             ("K9 win_dsend", "win_dsend.cu", "deep_gcns_torch_tpu/ops/gat_dense.py:1048", "K9")),
            rows[GAT_SHAPES[1]]):
        out.append({"name": name, "route": "cuda", "source": f"{PKG}/csrc/{src}",
                    "replaces": line, "launches": launches[key],
                    "max_abs_err": errs["bf16"][key], "ms": t[0], "plain_ms": t[1],
                    "bound_ms": b[0], "bound_by": b[1], "library_ms": None})
    return out


# ---------------------------------------------------------------------------
# slice 6: K10 (the block-sparse SpMM), the checkpoint path, remat
# ---------------------------------------------------------------------------

def bsp_graph(n, dev):
    """tests/test_blocksparse.py:20-23's banded graph at the TPU prototype's
    shape (ROOFLINE.md:353): degree 15, bandwidth 256, seed 0; its tiles for
    A and Aᵀ, built on the host."""
    rng = np.random.default_rng(0)
    s = rng.integers(0, n, n * 15)
    r = np.clip(s + rng.integers(-256, 257, n * 15), 0, n - 1)
    n_pad = -(-n // 256) * 256  # the graph builder's node padding: 169,472 rows
    t0 = time.time()
    tiles, tiles_t = tbs.build_block_tiles(s, r, n_pad)
    build_s = time.time() - t0
    log(f"[bsp-graph] N={n} N_pad={n_pad} E={len(s)}; host build of both directions "
        f"{build_s:.2f}s; fill {tiles.fill:.4f} / {tiles_t.fill:.4f}; tiles "
        f"{tiles.n_tiles} / {tiles_t.n_tiles}")
    return dict(s=s, r=r, n_pad=n_pad, tiles=tiles.to(dev), tiles_t=tiles_t.to(dev))


def phase_bsp_kernels(bg, dev):
    """K10 against its plain version: forward (A) and transpose (Aᵀ) tiles,
    f32 and bf16, C=128 and C=40 (not a multiple of 128), directly and
    through the Function's backward; and a graph whose first and last
    receiver blocks have no edge, which must come out exact 0."""
    chk = Checks("bsp kernels")
    gen = torch.Generator(device=dev).manual_seed(3)
    n_pad, tiles, tiles_t = bg["n_pad"], bg["tiles"], bg["tiles_t"]
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        tag = "f32" if dtype == torch.float32 else "bf16"
        for c in (128, 40, 3):
            x = torch.randn(n_pad, c, device=dev, generator=gen).to(dtype)
            co = torch.randn(n_pad, c, device=dev, generator=gen).to(dtype)
            out = tbs.bsp_call(x, tiles)
            chk.equal(f"K10 forward {tag} C={c} two launches bit for bit", tbs.bsp_call(x, tiles),
                      out)
            e = max(chk.close(f"K10 forward {tag} C={c}", out,
                              tbs.bsp_call_plain(x, tiles), **tol),
                    chk.close(f"K10 transpose {tag} C={c}", tbs.bsp_call(co, tiles_t),
                              tbs.bsp_call_plain(co, tiles_t), **tol))
            res = []
            for fn in (tbs.block_spmm, tbs.block_spmm_plain):
                xx = x.clone().requires_grad_(True)
                out = fn(xx, tiles, tiles_t)
                out.backward(co)
                res.append((out.detach(), xx.grad))
            e = max(e, chk.close(f"block_spmm out {tag} C={c}", res[0][0], res[1][0], **tol),
                    chk.close(f"block_spmm dx {tag} C={c}", res[0][1], res[1][1], **tol))
            if c == 128:
                errs[tag] = e
            del x, co, res, out
    rng = np.random.default_rng(1)
    n = 40 * tbs.BN
    s = rng.integers(0, n, n * 12)
    r = np.clip(s + rng.integers(-300, 301, n * 12), tbs.BN, n - tbs.BN - 1)
    et, et_t = (t.to(dev) for t in tbs.build_block_tiles(s, r, n))
    x = torch.randn(n, 128, device=dev, generator=gen).to(torch.bfloat16)
    out = tbs.bsp_call(x, et)
    chk.close("K10 with empty receiver blocks bf16", out, tbs.bsp_call_plain(x, et), **TOL_BF16)
    zero = torch.zeros(tbs.BN, 128, dtype=torch.bfloat16, device=dev)
    chk.equal("K10 empty receiver block 0 is exact 0", out[:tbs.BN], zero)
    chk.equal("K10 empty last receiver block is exact 0", out[-tbs.BN:], zero)
    # cells that bf16 cannot hold as one count: one (r, s) edge 300 times in a
    # tile beside others, and one 520 times (a full tile of 512, then more);
    # integer-valued x keeps every float32 sum exact, so kernel and plain
    # version must agree bit for bit
    s = np.concatenate([s, np.full(300, 3 * tbs.BN + 7), np.full(520, 9 * tbs.BN + 100)])
    r = np.concatenate([r, np.full(300, 2 * tbs.BN + 5), np.full(520, 9 * tbs.BN + 1)])
    mt, mt_t = (t.to(dev) for t in tbs.build_block_tiles(s, r, n))
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for c in (128, 40, 3):
            xi = torch.randint(-8, 9, (n, c), device=dev, generator=gen).to(dtype)
            for direction, tl in (("forward", mt), ("transpose", mt_t)):
                chk.equal(f"K10 300- and 520-fold cells {direction} {tag} C={c} exact",
                          tbs.bsp_call(xi, tl), tbs.bsp_call_plain(xi, tl))
    sync(dev)
    chk.raise_if_failed()
    return errs


def phase_bsp_timing(bg, errs, iters):
    """K10's drive (the module's entry point `block_spmm`, forward and
    backward once, counts set to 0 just before), then its time in bf16 at
    C=128 beside its plain version, `torch.sparse.mm` of the same adjacency
    and K1 (gathered form) on the same edges, and its bound; and K10 in
    float32 beside `torch.sparse.mm` in float32."""
    dev = bg["tiles"].offs.device
    chk = Checks("bsp timing")
    n_pad, tiles, tiles_t, c = bg["n_pad"], bg["tiles"], bg["tiles_t"], 128
    s, r = bg["s"], bg["r"]
    e = len(s)
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(n_pad, c, device=dev, generator=gen).to(torch.bfloat16)
    reset_launches()
    xx = x.clone().requires_grad_(True)
    tbs.block_spmm(xx, tiles, tiles_t).backward(x)
    sync(dev)
    launches = read_launches()
    want = dict(no_launches(), K10=2 if dev.type == "cuda" else 0)
    log(f"[bsp] block_spmm forward and backward once: launches {launches}")
    if launches != want:
        raise AssertionError(f"bsp: kernel launches {launches} != expected {want}")
    k10_ms = time_fn(lambda: tbs.bsp_call(x, tiles), dev, iters)
    plain_ms = time_fn(lambda: tbs.bsp_call_plain(x, tiles), dev, 3)
    # yardsticks (never called by the port): A as one CSR matrix A[r, s] = #edges
    # s→r for torch.sparse.mm (float32 on the CPU, which has no bf16 sparse
    # product), and K1's gathered form over the receiver-sorted senders
    xy = x if dev.type == "cuda" else x.float()
    coo = torch.sparse_coo_tensor(torch.from_numpy(np.stack([r, s])).to(dev),
                                  torch.ones(e, device=dev), (n_pad, n_pad),
                                  check_invariants=True).coalesce()
    csr = coo.to_sparse_csr()
    a = torch.sparse_csr_tensor(csr.crow_indices(), csr.col_indices(),
                                csr.values().to(xy.dtype), (n_pad, n_pad),
                                check_invariants=True)
    lib_ms = time_fn(lambda: torch.sparse.mm(a, xy), dev, iters)
    order = np.argsort(r, kind="stable")
    idx = torch.from_numpy(s[order].astype(np.int32)).to(dev)
    ptr = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(np.bincount(r, minlength=n_pad))]).astype(np.int32)).to(dev)
    k1_ms = time_fn(lambda: tsp.csr_seg_sum(x, ptr, idx), dev, iters)
    out = tbs.bsp_call(x, tiles)
    chk.close("library yardstick sparse.mm vs K10", torch.sparse.mm(a, xy), out, **TOL_LIBRARY)
    chk.close("K1 on the same edges vs K10", tsp.csr_seg_sum(x, ptr, idx), out, **TOL_BF16)
    # float32: K10's three exact bf16 planes beside torch.sparse.mm in float32
    x32 = x.float()
    a32 = torch.sparse_csr_tensor(csr.crow_indices(), csr.col_indices(), csr.values().float(),
                                  (n_pad, n_pad), check_invariants=True)
    k10_f32_ms = time_fn(lambda: tbs.bsp_call(x32, tiles), dev, iters)
    lib_f32_ms = time_fn(lambda: torch.sparse.mm(a32, x32), dev, iters)
    chk.close("library yardstick sparse.mm vs K10, float32", torch.sparse.mm(a32, x32),
              tbs.bsp_call(x32, tiles), **TOL_F32)
    chk.raise_if_failed()
    log(f"[bsp] float32: K10 {k10_f32_ms:.4f} ms, torch.sparse.mm {lib_f32_ms:.4f} ms "
        f"({k10_f32_ms / lib_f32_ms:.4f}); card: {CARD}")
    nt = tiles.n_tiles
    # x read once and out written once (bf16); the offsets (uint8, two rows a
    # tile), tile_sb and tile_start as stored; one f32 add per (edge, channel)
    bytes_moved = 2 * n_pad * c * 2 + nt * 2 * tbs.T + 4 * nt + 4 * (tiles.n_blocks + 1)
    b = bound(bytes_moved, e * c)
    log(f"[bsp] K10 {k10_ms:.4f} ms, plain {plain_ms:.3f} ms, torch.sparse.mm "
        f"{lib_ms:.4f} ms, K1 on the same edges {k1_ms:.4f} ms; bound {b[0]:.4f} ms "
        f"({b[1]}, {bytes_moved / 1e6:.1f} MB); fill {tiles.fill:.4f}, {nt} tiles; "
        f"card: {CARD}")
    log(f"[bsp] K10 / torch.sparse.mm {k10_ms / lib_ms:.4f}, K10 / K1 {k10_ms / k1_ms:.4f}, "
        f"K10 / bound {k10_ms / b[0]:.2f}; the dense tile products "
        f"{2 * tbs.BN * tbs.SB * c * nt / 1e9:.1f} GFLOP take "
        f"{2 * tbs.BN * tbs.SB * c * nt / BF16_TENSOR_FLOP_PER_S * 1e3:.4f} ms at the bf16 "
        f"tensor-core peak; card: {CARD}")
    return {"name": "K10 block_spmm", "route": "cuda", "source": f"{PKG}/csrc/blocksparse.cu",
            "replaces": "deep_gcns_torch_tpu/ops/blocksparse.py:123",
            "launches": launches["K10"], "max_abs_err": errs["bf16"], "ms": k10_ms,
            "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1], "library_ms": lib_ms}


def phase_ckpt_arxiv(dev, rehearse):
    """The checkpoint path through the apps at ResGEN-28's full width
    (`bench.py:54-61`, bf16) on the synthetic ogbn-arxiv stand-in: train 2
    epochs with `--save_ckpt`, resume from the saved epoch to epoch 4, and
    score the checkpoint with `apps/ogbn_arxiv_test`, whose accuracies must
    equal those the training run printed at that epoch, with K2 launched."""
    layers = 3 if rehearse else 28
    base = ["--synthetic", "--synthetic_nodes", "2000" if rehearse else "169343",
            "--num_layers", str(layers), "--compute_dtype", "bfloat16", "--device", dev.type]
    t0 = time.time()
    first = ogbn_arxiv.main(base + ["--epochs", "2", "--save_ckpt", "--exp_root", RUNS])
    t1 = time.time()
    ckpt = first["ckpt"]
    with open(ckpt + ".json") as f:
        meta = json.load(f)
    k = meta["epoch"]
    best = max(v["valid"] for v in first["evals"].values())
    if meta["best_value"] != best or not os.path.exists(ckpt + "_best.pth"):
        raise AssertionError(f"ckpt: saved {meta}, best valid {best}")
    resumed = ogbn_arxiv.main(base + ["--epochs", "4", "--pretrained_model", ckpt])
    t2 = time.time()
    if len(resumed["losses"]) != 4 - k or not all(map(math.isfinite, resumed["losses"])):
        raise AssertionError(f"ckpt: resumed from epoch {k}: losses {resumed['losses']}")
    reset_launches()
    scored = ogbn_arxiv_test.main(base + ["--pretrained_model", ckpt])
    launches = read_launches()
    t3 = time.time()
    log(f"[ckpt-arxiv] saved at epoch {k} ({meta}); training accuracies {first['evals'][k]}, "
        f"test script {scored['accs']}; resumed losses {resumed['losses']}; launches of "
        f"the test script {launches}; train {t1 - t0:.1f}s, resume {t2 - t1:.1f}s, "
        f"score {t3 - t2:.1f}s (host clock, data built each time); card: {CARD}")
    if scored["accs"] != first["evals"][k]:
        raise AssertionError(f"ckpt: the test script's accuracies {scored['accs']} != "
                             f"{first['evals'][k]} at the saved epoch")
    if dev.type == "cuda" and launches["K2"] != layers:
        raise AssertionError(f"ckpt: the test script's predict launched {launches}")


def phase_ckpt_revgat(dev, rehearse):
    """RevGAT's teacher with `--save_ckpt`, then a student distilled from
    its checkpoint (`--mode student --teacher_ckpt`), 2 epochs each, small."""
    argv = ["--synthetic", "--synthetic_nodes", "1000" if rehearse else "20000",
            "--epochs", "2", "--compute_dtype", "bfloat16", "--device", dev.type,
            "--exp_root", RUNS]
    t0 = time.time()
    teacher = ogbn_arxiv_dgl.main(argv + ["--save_ckpt"])
    reset_launches()
    student = ogbn_arxiv_dgl.main(argv + ["--mode", "student", "--teacher_ckpt",
                                          teacher["ckpt"]])
    launches = read_launches()
    log(f"[ckpt-revgat] teacher {teacher}; student {student}; student launches {launches}; "
        f"{time.time() - t0:.1f}s")
    if not os.path.exists(teacher["ckpt"] + ".pth") or not math.isfinite(student["loss"]):
        raise AssertionError(f"ckpt-revgat: teacher {teacher}, student {student}")
    if dev.type == "cuda" and (launches["K5"] == 0 or launches["K6"] == 0):
        raise AssertionError(f"ckpt-revgat: K5/K6 did not run: {launches}")


def phase_ckpt_proteins(dev, rehearse):
    """The RevGCN proteins app for one epoch with `--save_ckpt` (the
    asynchronous rolling checkpoint and `ckpt_best`), then
    `apps/ogbn_proteins_test` on the rolling checkpoint with the training
    run's evaluation partition: its ROC-AUCs agree with the app's."""
    argv = ["--synthetic", "--synthetic_nodes", "3000" if rehearse else "20000",
            "--synthetic_degree", "8" if rehearse else "60", "--cluster_number", "10",
            "--num_layers", "3" if rehearse else "14", "--eval_parts", "5",
            "--compute_dtype", "bfloat16", "--device", dev.type]
    t0 = time.time()
    res = ogbn_proteins_rev.main(argv + ["--epochs", "1", "--save_ckpt", "--exp_root", RUNS])
    kept = sorted(os.listdir(os.path.join(res["exp"], "ckpt")))
    t1 = time.time()
    reset_launches()
    out = ogbn_proteins_test.main(argv + ["--num_evals", "1", "--pretrained_model",
                                          os.path.join(res["exp"], "ckpt", "0", "ckpt")])
    launches = read_launches()
    peak = out["peak_bytes"]
    log(f"[ckpt-proteins] app {res['results']} (kept {kept}, {t1 - t0:.1f}s); test script "
        f"{out['aucs']}, epoch {out['meta']['epoch']}, peak "
        f"{'not measured' if peak is None else f'{peak / 2**30:.3f} GB'}, "
        f"{time.time() - t1:.1f}s; launches {launches}; card: {CARD}")
    # the same partition and weights; only the edge padding of the clusters
    # differs (the app pads to its training bucket), which may move bf16
    # roundings of the cluster-wide shift, not the ranking beyond 1e-3
    if kept != ["0"] or not os.path.exists(os.path.join(res["exp"], "ckpt_best.pth")) or any(
            abs(out["aucs"][k] - v) > 1e-3 for k, v in res["results"].items()):
        raise AssertionError(f"ckpt-proteins: kept {kept}, app {res['results']}, "
                             f"test script {out['aucs']}")
    if dev.type == "cuda" and launches["K2 ee"] == 0:
        raise AssertionError(f"ckpt-proteins: K2 with ee did not run: {launches}")


def phase_remat(g, labels, layers):
    """ResGEN-28 on the main graph with `remat` and `checkpoint_prologue`
    against the same weights without them, the same dropout generator seed:
    one warm-up step each (the loss bit for bit, every gradient within
    TOL_BWD_BF16), then one timed step each with its peak and launches (the
    re-forward runs K2 once more for each of layers 1..L-1)."""
    dev = g.senders.device
    chk = Checks("remat")
    lab = torch.zeros(g.num_nodes_padded, dtype=torch.long)
    lab[:g.n_node] = torch.from_numpy(np.asarray(labels))
    lab = lab.to(dev)
    runs = {}
    for name, knobs in (("plain", {}), ("remat", dict(remat=True, checkpoint_prologue=True))):
        cfg = DeeperGCNConfig(in_channels=128, hidden_channels=128, num_tasks=40,
                              num_layers=layers, block="res+", aggr="softmax_sg", t=0.1,
                              norm="batch", mlp_layers=1, dropout=0.5,
                              compute_dtype="bfloat16", **knobs)
        model = DeeperGCN(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
        runs[name] = (model, make_optimizer("adam", model.parameters(), 1e-2),
                      torch.Generator(device=dev).manual_seed(1))
    warm = {}
    for name, (model, opt, gen) in runs.items():
        loss = float(ogbn_arxiv.train_step(model, opt, g, lab, g.node_mask, gen))
        warm[name] = (loss, {k: p.grad.detach().clone() for k, p in model.named_parameters()})
    chk.equal("remat warm-up loss bit for bit", torch.tensor(warm["remat"][0]),
              torch.tensor(warm["plain"][0]))
    err = max(chk.close(f"remat grad {k}", warm["remat"][1][k], want, **TOL_BWD_BF16)
              for k, want in warm["plain"][1].items())
    del warm
    info = {}
    for name, (model, opt, gen) in runs.items():
        # the peak of this step alone; the allocator keeps its cache, so that
        # neither step pays for fresh device allocations
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        t0 = time.perf_counter()
        loss = ogbn_arxiv.train_step(model, opt, g, lab, g.node_mask, gen)
        sync(dev)
        info[name] = {"step_ms": (time.perf_counter() - t0) * 1e3, "loss": float(loss),
                      "launches": read_launches(),
                      "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                     if dev.type == "cuda" else None)}
    log(f"[remat] {json.dumps(info)}; largest gradient error {err:.3e}; card: {CARD}")
    if dev.type == "cuda":
        p, r = info["plain"], info["remat"]
        log(f"[remat] step {r['step_ms']:.3f} ms with remat against {p['step_ms']:.3f} ms "
            f"(ratio {r['step_ms'] / p['step_ms']:.4f}); peak {r['peak_bytes'] / 2**30:.3f} "
            f"against {p['peak_bytes'] / 2**30:.3f} GiB; card: {CARD}")
    chk.raise_if_failed()
    want = {"plain": no_launches(), "remat": no_launches()}
    if dev.type == "cuda":
        # K11: each of layers 1..L-1's prologues runs again in the body's
        # recompute and once more in its own
        want["plain"].update({"K4": layers, "K2": layers, "K11 fwd": layers,
                              "K11 bwd": layers})
        want["remat"].update({"K4": layers, "K2": 2 * layers - 1, "K11 fwd": 3 * layers - 2,
                              "K11 bwd": layers})
        if not info["remat"]["peak_bytes"] < info["plain"]["peak_bytes"]:
            raise AssertionError(f"remat: peak {info['remat']['peak_bytes']} not below "
                                 f"{info['plain']['peak_bytes']}")
    for name in info:
        if info[name]["launches"] != want[name]:
            raise AssertionError(f"remat: {name} launches {info[name]['launches']} != "
                                 f"{want[name]}")
    return info


# slice 11: GENConv's mean through K1, K1's corner cases and its shapes

def phase_mean_route(g, labels, layers, steps):
    """A small mean DeeperGCN card against CPU, then ResGEN-28 with
    `aggr="mean"` on the main graph (phase 4's model and graph otherwise)
    through the app's `train_step` and `predict`: K1 56 launches a step (28
    plain-form forward, 28 gathered backward), 28 a `predict`, K2 none; and
    a profile of one more step."""
    phase_agreement(g.senders.device, aggr="mean")
    _, state = phase_main_path(g, labels, layers, steps, tag="mean-route", aggr="mean")
    phase_profile(g.senders.device, arxiv_step(g, state), tag="mean-route-profile")


def k1_corner_graph(dev):
    """3,000 nodes: a receiver of 5,000 edges and a sender of 5,000 (hub rows
    of both forms), the last 100 nodes with no edge either way, and the edge
    arrays padded with the sentinel N_pad, which K1 must never read (the
    graph of `tests/test_torch_cuda.py::test_seg_sum_corner_cases`)."""
    n, e = 3000, 30000
    rng = np.random.default_rng(41)
    s, r = rng.integers(0, n - 100, e), rng.integers(0, n - 100, e)
    r[:5000] = 7
    s[5000:10000] = 11
    return build_graph(None, s, r, num_nodes=n).to(dev)


def phase_k1_corners(dev):
    """K1 in both forms on `k1_corner_graph` at C=8, 30, 48, 128, 392 and 776
    (lane groups over rows, 16-byte bf16 loads, scalar loads, one warp
    holding one to eight slots a lane), f32 and bf16: against the plain
    version, rows with no edge exact 0, two launches bit for bit."""
    chk = Checks("k1 corners")
    g = k1_corner_graph(dev)
    if int(g.csc_receivers[g.n_edge:].min()) != g.num_nodes_padded:
        raise AssertionError("k1 corners: the CSC index is not sentinel-padded")
    gen = torch.Generator(device=dev).manual_seed(41)
    for c in (8, 30, 48, 128, 392, 776):
        for dtype, tag, tol in ((torch.float32, "f32", TOL_F32),
                                (torch.bfloat16, "bf16", TOL_BF16)):
            msgs = torch.randn(g.num_edges_padded, c, device=dev, generator=gen).to(dtype)
            src = torch.randn(g.num_nodes_padded, c, device=dev, generator=gen).to(dtype)
            zero = torch.zeros(g.num_nodes_padded - 2900, c, dtype=dtype, device=dev)
            for form, args in (("plain", (msgs, g.row_ptr)),
                               ("gathered", (src, g.csc_col_ptr, g.csc_receivers))):
                name = f"K1 {form} C={c} {tag}"
                out = tsp.csr_seg_sum(*args)
                chk.close(name, out, tsp.csr_seg_sum_plain(*args), **tol)
                chk.equal(f"{name} rows with no edge exact 0", out[2900:], zero)
                chk.equal(f"{name} two launches bit for bit", tsp.csr_seg_sum(*args), out)
    sync(dev)
    chk.raise_if_failed()


def _without_long_rows(ptr, idx, limit=64):
    """(ptr, idx) of a gathered CSR with the rows of more than ``limit``
    edges emptied, and the share of the edges they held."""
    cnt = (ptr[1:] - ptr[:-1]).long()
    keep = cnt <= limit
    rows = torch.repeat_interleave(torch.arange(cnt.shape[0], device=ptr.device), cnt)
    new = torch.zeros_like(ptr)
    new[1:] = torch.cumsum(torch.where(keep, cnt, 0), 0).to(ptr.dtype)
    kept = idx[int(ptr[0]):int(ptr[-1])][keep[rows]].contiguous()
    return new, kept, 1.0 - kept.shape[0] / max(rows.shape[0], 1)


def phase_k1_timing(g, lo, iters):
    """K1 at every shape of `K1_PATHS` (`k1_inputs`): `time_fn`'s time, the
    device time (`device_ms`), the bound (src's rows that the edges read,
    each read once, out written once, the index and pointers; one float32 add
    per edge and channel), the time if every gathered row came from HBM, the
    plain version's time and a library time beside it (the gathered form:
    `torch.sparse.mm` of the count matrix; the plain form:
    `torch.segment_reduce`); and the gathered shapes without their rows of
    more than 64 edges."""
    dev = g.senders.device
    chk = Checks("k1 timing")
    for key, (src, ptr, idx) in k1_inputs(g, lo, torch.Generator(device=dev).manual_seed(6)
                                          ).items():
        n_rows, c, size = ptr.shape[0] - 1, src.shape[1], src.element_size()
        e0, e1 = int(ptr[0]), int(ptr[-1])
        e = e1 - e0
        ms = time_fn(lambda: tsp.csr_seg_sum(src, ptr, idx), dev, iters)
        d_ms = device_ms(lambda: tsp.csr_seg_sum(src, ptr, idx), dev, iters)
        plain_ms = time_fn(lambda: tsp.csr_seg_sum_plain(src, ptr, idx), dev, 3)
        out = tsp.csr_seg_sum(src, ptr, idx)
        fixed = 4 * (n_rows + 1) + n_rows * c * size + (4 * e if idx is not None else 0)
        read = e if idx is None else int(torch.unique(idx[e0:e1]).numel())
        b = bound(fixed + read * c * size, e * c)
        hbm_ms = (fixed + e * c * size) / HBM_BYTES_PER_S * 1e3
        # yardsticks (never called by the port); the CPU rehearsal runs them
        # in float32, where the CPU's sparse product has no bfloat16
        y = src if dev.type == "cuda" else src.float()
        if idx is None:
            offsets = ptr.long() - e0

            def lib():
                return torch.segment_reduce(y[e0:e1], "sum", offsets=offsets, axis=0)
        else:
            coo = torch.sparse_coo_tensor(
                torch.stack([torch.repeat_interleave(torch.arange(n_rows, device=dev),
                                                     (ptr[1:] - ptr[:-1]).long()),
                             idx[e0:e1].long()]),
                torch.ones(e, device=dev), (n_rows, src.shape[0])).coalesce().to_sparse_csr()
            a = torch.sparse_csr_tensor(coo.crow_indices(), coo.col_indices(),
                                        coo.values().to(y.dtype), (n_rows, src.shape[0]))

            def lib():
                return torch.sparse.mm(a, y)
        lib_ms = time_fn(lib, dev, iters)
        chk.close(f"library yardstick vs K1 {key}", lib(), out, **TOL_LIBRARY)
        row = {"ms": ms, "device_ms": d_ms, "bound_ms": b[0], "bound_by": b[1],
               "all_from_hbm_ms": hbm_ms if idx is not None else None,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "library": "torch.segment_reduce" if idx is None else "torch.sparse.mm",
               "rows": n_rows, "edges": e,
               "longest_row": int((ptr[1:] - ptr[:-1]).max()) if n_rows else 0,
               "launches": K1_PATHS[key]}
        if idx is not None:
            p64, i64, share = _without_long_rows(ptr, idx)
            row["without_rows_over_64_edges"] = {
                "ms": time_fn(lambda: tsp.csr_seg_sum(src, p64, i64), dev, iters),
                "device_ms": device_ms(lambda: tsp.csr_seg_sum(src, p64, i64), dev, iters),
                "edge_share_left_out": share}
        log(f"[k1-timing] {key}: {json.dumps(row)}")
        del src, out, lib
    chk.raise_if_failed()
    log(f"[k1-timing] card: {CARD}")


def _sha256(*tensors):
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


# K1 at the shapes its paths give it: key -> the path and its launches
K1_PATHS = {
    "gather C=128 bf16": "ResGEN-28 gather route backward, 28 a step; the mean route's "
                         "backward, 28 a step",
    "gather C=128 f32": "the same in float32",
    "plain C=128 bf16": "the mean route's forward, 28 a step + 28 a predict",
    "lo C=392 bf16": "dense RevGAT _lo_sum / _lo_dsend at 3x128",
    "lo C=776 bf16": "dense RevGAT _lo_sum / _lo_dsend at 3x256",
    "lo C=48 bf16": "dense RevGAT _lo_sum / _lo_dsend at 1x40",
    "lo C=8 f32": "dense RevGAT _lo_der",
    "band-lo C=128 bf16": "ResGEN-28 band route's leftover, backward: 28 a step",
    "band-lo C=256 bf16": "the same, forward (the packed [e·m | e] table): 28 a step + 28 a "
                          "predict",
}


def k1_inputs(g, lo, gen):
    """{key of `K1_PATHS`: (src, ptr, idx)} on random values: the gathered
    form over the main graph ``g``'s CSC (the gather route's backward), the
    plain form over its CSR (the mean route's forward), the plain form over
    the RevGAT band's leftover at the dense route's packed widths (`_lo_sum`
    and `_lo_dsend` at 3x128, 3x256, 1x40: 392, 776 and 48 columns in bf16;
    `_lo_der`'s 8 in f32), and the gathered form over the ResGEN band's
    leftover at the band route's widths (the backward's 128 columns, the
    forward's packed 256). ``lo`` holds the leftovers' CSR: "band" the
    ResGEN band's forward (lo_row_ptr, lo_src), "gat" the RevGAT band's
    forward (lo_row_ptr, n_lo)."""
    dev = g.senders.device

    def rnd(rows, c, dtype):
        return torch.randn(rows, c, device=dev, generator=gen).to(dtype)

    n_pad, bf16, f32 = g.num_nodes_padded, torch.bfloat16, torch.float32
    gat_ptr, n_lo = lo["gat"]
    band_ptr, band_src = lo["band"]
    return {"gather C=128 bf16": (rnd(n_pad, 128, bf16), g.csc_col_ptr, g.csc_receivers),
            "gather C=128 f32": (rnd(n_pad, 128, f32), g.csc_col_ptr, g.csc_receivers),
            "plain C=128 bf16": (rnd(g.num_edges_padded, 128, bf16), g.row_ptr, None),
            "lo C=392 bf16": (rnd(n_lo, 392, bf16), gat_ptr, None),
            "lo C=776 bf16": (rnd(n_lo, 776, bf16), gat_ptr, None),
            "lo C=48 bf16": (rnd(n_lo, 48, bf16), gat_ptr, None),
            "lo C=8 f32": (rnd(n_lo, 8, f32), gat_ptr, None),
            "band-lo C=128 bf16": (rnd(band_ptr.shape[0] - 1, 128, bf16), band_ptr,
                                   band_src),
            "band-lo C=256 bf16": (rnd(band_ptr.shape[0] - 1, 256, bf16), band_ptr,
                                   band_src)}


# the seed of the `resgen28-arxiv-gather` benchmark cell's graph that PERF.md's
# K2 hub timings were taken on
K2_CELL_SEED = 2147022031


def k2_cell_ranges(n):
    """Host (row_ptr, senders) of the `resgen28-arxiv-gather` benchmark cell's
    graph at ``n`` nodes (the cell's own at 169,343), and its padded node
    count: `h100bench/traffic/arxiv-powerlaw.json`'s power-law community
    edges drawn as `graphgen.make_inputs` draws them from `K2_CELL_SEED`,
    made undirected with one self-loop a node and built as the harness
    builds them."""
    from h100bench import graphgen

    with open(os.path.join(ROOT, "h100bench", "traffic", "arxiv-powerlaw.json")) as f:
        traffic = json.load(f)
    s, r = graphgen.GENERATORS[traffic["generator"]](
        np.random.default_rng([K2_CELL_SEED, 0]), **{**traffic["params"], "n": n})
    s, r = add_self_loops(*to_undirected(s, r), n)
    g = build_graph(None, s, r, num_nodes=n, with_csc=False)
    return g.row_ptr.numpy(), g.senders[:g.n_edge].numpy(), g.num_nodes_padded


def _cut_rows(row_ptr, senders, keep_row, cap):
    """Host (row_ptr, senders) of the rows in ``keep_row``, each cut to its
    first ``cap`` edges; the other rows empty."""
    counts = np.diff(row_ptr).astype(np.int64)
    new = np.where(keep_row, np.minimum(counts, cap), 0)
    pos = np.arange(senders.shape[0]) - np.repeat(row_ptr[:-1].astype(np.int64), counts)
    rp = np.zeros(row_ptr.shape[0], np.int64)
    np.cumsum(new, out=rp[1:])
    return rp.astype(np.int32), senders[np.repeat(new, counts) > pos]


def k2_cell_times(n, dev, gen, iters, res, digests=None):
    """K2 float32 at C = 128 on `k2_cell_ranges`' graph: ``cell`` the graph as
    the program runs it (its long rows split, `k2_split_rows`), ``cell
    unsplit`` the same launch splitting none, ``cell rest`` every row cut to
    its first 128 edges, ``cell hubs`` its 8 longest rows alone; each
    variant but the unsplit one at its own count of split rows. ``digests``
    takes a digest of ``cell``'s out and lse."""
    rp_h, s_h, n_pad = k2_cell_ranges(n)
    counts = np.diff(rp_h)
    hubs = np.zeros(n_pad, bool)
    hubs[np.argsort(-counts, kind="stable")[:8]] = True
    x = torch.randn(n_pad, 128, device=dev, generator=gen)
    t = torch.tensor([0.1], device=dev)
    for name, (rp, sd) in (("cell", (rp_h, s_h)),
                           ("cell rest", _cut_rows(rp_h, s_h, np.ones(n_pad, bool), 128)),
                           ("cell hubs", _cut_rows(rp_h, s_h, hubs, counts.max()))):
        k = tsp.k2_split_rows(rp)
        args = (x, torch.from_numpy(np.ascontiguousarray(sd, np.int32)).to(dev),
                torch.from_numpy(rp).to(dev), torch.from_numpy(longest_first(rp)).to(dev),
                t, 1e-7)
        res[f"K2 {name} f32"] = time_fn(lambda: tsp.softmax_agg(*args, split_rows=k), dev,
                                        iters)
        if name == "cell":
            res["K2 cell unsplit f32"] = time_fn(lambda: tsp.softmax_agg(*args), dev, iters)
            if digests is not None:
                digests["K2 cell f32"] = _sha256(*tsp.softmax_agg(*args, split_rows=k))


def phase_kernel_times(dev, n, cluster, iters, hashes=False):
    """`--kernel-times`: `time_fn`'s times of K2 at C=128 on the main graph
    and on the benchmark cell's graph (`k2_cell_times`);
    K2 with `ee` at C=40 and 64, K4 without dt at C=40 and with dt at C=64
    on the cluster graph (phase 14's inputs); K7, K9 and K8 at 3x128, 3x256
    and 1x40 on the RevGAT graph's band with the step's hash drop (phase
    29's inputs; float32 at 3x128 only); K5 and K6 at P=392, 776 and 48 with
    the step's hash keep (phase 25's inputs; float32 at P=392 only); K10 at
    C=128 on the block-sparse graph; K1 at every key of `K1_PATHS`
    (`k1_inputs`), whose device times (`device_ms`) the line also holds;
    each in float32 and bfloat16 unless said, as one JSON line beside the
    card's name and power limit. No check and no model
    runs. ``hashes`` (`--output-hashes`) adds a digest of each K1, K5, K6
    (dmsg and d_el apart), K7, K8 and K9 output and K2's on the cell's
    graph, so that two commits'
    kernels compare bit for bit on one card."""
    res, dev_res, digests = {}, {}, {}
    gen = torch.Generator(device=dev).manual_seed(5)
    g, _ = main_graph(n, dev)
    t = torch.tensor([0.1], device=dev)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        x = g.x.to(dtype).contiguous()
        res[f"K2 C=128 {tag}"] = time_fn(
            lambda: tsp.softmax_agg(x, g.senders, g.row_ptr, g.row_order, t, 1e-7), dev, iters)
    k2_cell_times(n, dev, gen, iters, res, digests if hashes else None)
    g_main = g  # K1's main-graph shapes, timed beside the leftovers below
    gb, _, _ = band_graph(n, dev)
    k1_lo = {"band": (gb.band.fwd.lo_row_ptr, gb.band.fwd.lo_src)}
    del g, x, gb
    g, _ = cluster_graph(*cluster, dev)
    t = torch.tensor([1.0], device=dev)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for c in (40, 64):
            x, ee, ee_csc = edge_inputs(g, c, dtype, gen)
            res[f"K2 ee C={c} {tag}"] = time_fn(
                lambda: tsp.softmax_agg(x, g.senders, g.row_ptr, g.row_order, t, 1e-7, ee), dev,
                iters)
            q = torch.randn(g.num_nodes_padded, c, device=dev, generator=gen).to(dtype)
            gw = c == 64
            out, lse = tsp.softmax_agg(x, g.senders, g.row_ptr, g.row_order, t, 1e-7, ee)
            if gw:
                q = torch.cat([q, out], 1).contiguous()
            res[f"K4 {'dt ' if gw else ''}C={c} {tag}"] = time_fn(
                lambda: tsp.softmax_bwd_csc(x, ee_csc, q, lse, g.csc_col_ptr, g.csc_order,
                                            g.csc_receivers, t, 1e-7, gw), dev, iters)
    del g, x, ee, ee_csc, q
    g, _ = revgat_graph(n, dev)
    band, spec = g.band.fwd, dense_drop(True)
    for (h, d), dtype, tag in (((3, 128), torch.bfloat16, "bf16"),
                               ((3, 256), torch.bfloat16, "bf16"),
                               ((1, 40), torch.bfloat16, "bf16"),
                               ((3, 128), torch.float32, "f32")):
        feat, el, er = dense_inputs(g, h, d, dtype, gen)
        m_other = dense_m_other(band, el, er, spec)
        res[f"K7 {h}x{d} {tag}"] = time_fn(
            lambda: tgd.win_fused(band, el, er, m_other, feat, 0.2, spec), dev, iters)
        gnum = torch.randn(feat.shape, device=dev, generator=gen).to(dtype)
        gden = torch.randn(el.shape, device=dev, generator=gen)
        m = tgd.win_fused(band, el, er, m_other, feat, 0.2, spec)[2]
        res[f"K9 {h}x{d} {tag}"] = time_fn(
            lambda: tgd.win_dsend(g.band.bwd, el, er, m, feat, gnum, gden, 0.2, spec), dev,
            iters)
        res[f"K8 {h}x{d} {tag}"] = time_fn(
            lambda: tgd.win_der(band, el, er, m, feat, gnum, gden, 0.2, spec), dev, iters)
        if hashes:
            digests[f"K7 {h}x{d} {tag}"] = _sha256(
                *tgd.win_fused(band, el, er, m_other, feat, 0.2, spec))
            d_el, d_feat = tgd.win_dsend(g.band.bwd, el, er, m, feat, gnum, gden, 0.2, spec)
            digests[f"K9 d_el {h}x{d} {tag}"] = _sha256(d_el)
            digests[f"K9 d_feat {h}x{d} {tag}"] = _sha256(d_feat)
            digests[f"K8 d_er {h}x{d} {tag}"] = _sha256(
                tgd.win_der(band, el, er, m, feat, gnum, gden, 0.2, spec))
            del d_el, d_feat
        del gnum, gden, m
    recv, keep_csc = gat_drop(g, True)
    for (h, d), dtype, tag in (((3, 128), torch.bfloat16, "bf16"),
                               ((3, 256), torch.bfloat16, "bf16"),
                               ((1, 40), torch.bfloat16, "bf16"),
                               ((3, 128), torch.float32, "f32")):
        hd = h * d
        t = gat_table(g, h, d, dtype, gen)
        cmax = tsp.gat_cmax(t, hd, h)
        fa = (g.senders, recv, g.row_ptr, cmax, hd, h, 0.2)
        key = f"P={t.shape[1]} {tag}"
        res[f"K5 {key}"] = time_fn(lambda: tsp.gat_fwd(t, *fa), dev, iters)
        q = torch.randn(t.shape, device=dev, generator=gen).to(dtype)
        ba = (g.csc_col_ptr, g.csc_receivers, keep_csc, cmax, hd, h, 0.2)
        res[f"K6 {key}"] = time_fn(lambda: tsp.gat_bwd_csc(t, q, *ba), dev, iters)
        if hashes:
            digests[f"K5 {key}"] = _sha256(tsp.gat_fwd(t, *fa))
            dt = tsp.gat_bwd_csc(t, q, *ba)
            digests[f"K6 dmsg {key}"] = _sha256(dt[:, :hd])
            digests[f"K6 d_el {key}"] = _sha256(dt[:, hd:])
            del dt
        del t, fa, q, ba
    k1_lo["gat"] = (g.band.fwd.lo_row_ptr, g.band.fwd.n_lo)
    k1 = k1_inputs(g_main, k1_lo, torch.Generator(device=dev).manual_seed(6))
    for key, (src, ptr, idx) in k1.items():
        res[f"K1 {key}"] = time_fn(lambda: tsp.csr_seg_sum(src, ptr, idx), dev, iters)
        dev_res[f"K1 {key}"] = device_ms(lambda: tsp.csr_seg_sum(src, ptr, idx), dev, iters)
        if hashes:
            digests[f"K1 {key}"] = _sha256(tsp.csr_seg_sum(src, ptr, idx))
    del g, band, feat, el, er, m_other, recv, keep_csc, k1, k1_lo, g_main, src, ptr, idx
    bg = bsp_graph(n, dev)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        x = torch.randn(bg["n_pad"], 128, device=dev, generator=gen).to(dtype)
        res[f"K10 C=128 {tag}"] = time_fn(lambda: tbs.bsp_call(x, bg["tiles"]), dev, iters)
    log(json.dumps({"root": ROOT, "card": CARD, "kernel_ms": res, "kernel_device_ms": dev_res,
                    **({"outputs_sha256": digests} if hashes else {})}))


# `--kernel-forms`: each kernel's forms, a copy of its source with some of the
# design's `constexpr int` constants replaced and, for some, attributes of the
# wrapper's module set (list sizes, walk forms, lane groups); the first form
# of each is the source as it stands. K7: passes whose counts a lane loads
# at once, blocks an SM keeps resident, the list; K9 and K8: the same, the
# gnum (K8: feat) values in flight and one walk at 3 x 256; K5: the
# sender-row values in flight, blocks an SM, one walk at 3 x 256, no lane
# groups at 1 x 40; K6: the same, and the reduce-scatter dot.
_ONE_WALK_FORMS = {4: (1, 2, 3, 6), 1: (8,)}
KERNEL_FORMS = {
    "K7": ("win_fused", (
        ("kept", {}, {}), ("1 pass a load", {"kScanBatch": 1}, {}),
        ("4 passes a load", {"kScanBatch": 4}, {}), ("1 block", {"kMinBlocks": 1}, {}),
        ("3 blocks", {"kMinBlocks": 3}, {}), ("5 blocks", {"kMinBlocks": 5}, {}),
        ("5 blocks, list 128", {"kMinBlocks": 5}, {"K7_MAX_LIST": 128}),
        ("6 blocks, list 128", {"kMinBlocks": 6}, {"K7_MAX_LIST": 128}),
        ("8 blocks, list 128", {"kMinBlocks": 8}, {"K7_MAX_LIST": 128}))),
    "K9": ("win_dsend", (
        ("kept", {}, {}),
        ("1 pass a load", {"kScanBatch": 1}, {}),
        ("half the rows in flight", {"kFlightValues": 12}, {}),
        ("twice the rows in flight", {"kFlightValues": 48}, {}),
        ("3 blocks", {"kMinBlocks": 3}, {}), ("2 blocks", {"kMinBlocks": 2}, {}),
        ("list 64", {}, {"K9_MAX_LIST": 64}), ("list 224", {}, {"K9_LIST_BYTES": 8192}),
        ("one walk at 3x256, 3 blocks", {"kMinBlocks": 3}, {"_K9_FORMS": _ONE_WALK_FORMS}))),
    "K5": ("gat_fwd", (
        ("kept", {}, {}),
        ("half the rows in flight", {"kFlightValues": 48}, {}),
        ("a quarter of the rows in flight", {"kFlightValues": 24}, {}),
        ("3 blocks", {"kMinBlocks": 3}, {}), ("6 blocks", {"kMinBlocks": 6}, {}),
        ("one walk at 3x256, 3 blocks", {"kMinBlocks": 3}, {"_K5_FORMS": _ONE_WALK_FORMS}),
        ("no lane groups", {}, {"k2_lane_groups": lambda c, vec, dtype=None: (32, 1)}))),
    "K8": ("win_der", (
        ("kept", {}, {}),
        ("1 pass a load", {"kScanBatch": 1}, {}),
        ("2/3 of the rows in flight", {"kFlightValues": 24}, {}),
        ("4/3 of the rows in flight", {"kFlightValues": 48}, {}),
        ("3 blocks", {"kMinBlocks": 3}, {}), ("5 blocks", {"kMinBlocks": 5}, {}),
        ("list 128", {}, {"K8_MAX_LIST": 128}),
        ("one walk at 3x256, 3 blocks", {"kMinBlocks": 3}, {"_K8_FORMS": _ONE_WALK_FORMS}))),
    "K6": ("gat_bwd_csc", (
        ("kept", {}, {}),
        ("butterfly dots", {"kDotScatter": 0}, {}),
        ("2 rows in flight", {"kFlightValues": 48, "kFlightDots": 6}, {}),
        ("3 blocks", {"kMinBlocks": 3}, {}), ("6 blocks", {"kMinBlocks": 6}, {}),
        ("three walks at 3x256", {}, {"_K6_FORMS": {4: (1, 2, 3), 1: (8,)}}),
        ("no lane groups", {}, {"k6_lane_groups": lambda hd, vec, dtype=None: (32, 1)}))),
    "K1": ("seg_sum", (
        ("kept", {}, {}),
        ("8-byte bf16 loads", {}, {"K1_WIDE_LOADS_MAX_C": 0}),
        ("16-byte bf16 loads at every width", {}, {"K1_WIDE_LOADS_MAX_C": 1 << 20}),
        ("16-byte bf16 loads up to C=256", {}, {"K1_WIDE_LOADS_MAX_C": 256}),
        ("2 edges in flight", {"kFlightGather": 2, "kFlightPlain": 2}, {}),
        ("gathered: 8 edges in flight", {"kFlightGather": 8}, {}),
        ("plain: 4 edges in flight", {"kFlightPlain": 4}, {}),
        ("32 registers a lane", {"kLaneRegs": 32}, {}),
        ("64 registers a lane", {"kLaneRegs": 64}, {}),
        ("6 blocks", {"kMinBlocks": 6}, {}), ("8 blocks", {"kMinBlocks": 8}, {}),
        ("128 channels a walk", {"kMaxSlots": 1}, {}),
        ("one warp a row", {},
         {"k1_layout": lambda c, vec, dtype=None: (min(32, -(-c // vec)), 1)}))),
}
FORM_SHAPES = (((3, 128), "bf16"), ((3, 256), "bf16"), ((1, 40), "bf16"), ((3, 128), "f32"))


def _build_form(src_name, consts, out, tag):
    """Starts `nvcc` on a copy of csrc/<src_name>.cu with ``consts`` replaced;
    returns (library path, process)."""
    import re

    src = open(os.path.join(_build.CSRC, f"{src_name}.cu")).read()
    for k, v in consts.items():
        src, hits = re.subn(rf"constexpr int {k} = \d+;", f"constexpr int {k} = {v};", src)
        if hits != 1:
            raise AssertionError(f"{k} not found once in {src_name}.cu")
    cu, so = os.path.join(out, f"{tag}.cu"), os.path.join(out, f"{tag}.so")
    with open(cu, "w") as f:
        f.write(src)
    cmd = [_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-I", _build.CSRC, "-o", so, cu]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)


def _k1_form_cases(k1):
    """{key: (call, check)} of K1 on `k1_inputs`' ``k1``: check(chk, name)
    holds one launch against the plain version and, after the first (kept)
    form's, bit for bit against that form's output."""
    cases, first = {}, {}
    for key, args in k1.items():
        tol = TOL_F32 if args[0].dtype == torch.float32 else TOL_BF16

        def call(a=args):
            return tsp.csr_seg_sum(*a)

        def check(chk, name, a=args, call=call, key=key, tol=tol):
            out = call()
            chk.close(f"K1 {name} {key}", out, tsp.csr_seg_sum_plain(*a), **tol)
            if key in first:
                chk.equal(f"K1 {name} {key} bit for bit the kept form's", out, first[key])
            else:
                first[key] = out

        cases[key] = (call, check)
    return cases


def _form_cases(kernel, g, gen):
    """{shape key: (call, check)} of one kernel on phase 25/29's inputs: the
    call launches the kernel; check(chk, name) holds one launch against the
    plain version."""
    dev = g.senders.device
    cases = {}
    for (h, d), tag in FORM_SHAPES:
        dtype = torch.float32 if tag == "f32" else torch.bfloat16
        key = f"{h}x{d} {tag}"
        if kernel == "K5":
            recv, _ = gat_drop(g, True)
            t = gat_table(g, h, d, dtype, gen)
            fa = (g.senders, recv, g.row_ptr, tsp.gat_cmax(t, h * d, h), h * d, h, 0.2)

            def call(t=t, fa=fa):
                return tsp.gat_fwd(t, *fa)

            def check(chk, name, t=t, fa=fa, call=call):
                chk.close(f"K5 {name}", call(), tsp.gat_fwd_plain(t, *fa), **TOL_BF16)
        elif kernel == "K6":
            _, keep_csc = gat_drop(g, True)
            t = gat_table(g, h, d, dtype, gen)
            q = torch.randn(t.shape, device=dev, generator=gen).to(dtype)
            hd = h * d
            ba = (t, q, g.csc_col_ptr, g.csc_receivers, keep_csc, tsp.gat_cmax(t, hd, h), hd,
                  h, 0.2)

            def call(ba=ba):
                return tsp.gat_bwd_csc(*ba)

            def check(chk, name, ba=ba, call=call, hd=hd):
                dt, want = call(), tsp.gat_bwd_csc_plain(*ba)
                chk.close(f"K6 {name} dmsg", dt[:, :hd], want[:, :hd], **TOL_BF16)
                chk.close(f"K6 {name} d_el", dt[:, hd:], want[:, hd:], **TOL_GAT_EL_BF16)
        else:
            band, spec = g.band.fwd, dense_drop(True)
            feat, el, er = dense_inputs(g, h, d, dtype, gen)
            m_other = dense_m_other(band, el, er, spec)
            if kernel == "K7":
                def call(a=(band, el, er, m_other, feat, 0.2, spec)):
                    return tgd.win_fused(*a)

                def check(chk, name, call=call, a=(band, el, er, m_other, feat, 0.2, spec)):
                    num, _, m = call()
                    num_p, _, m_p = tgd.win_fused_plain(*a)
                    chk.equal(f"K7 {name} M", m, m_p)
                    chk.close(f"K7 {name} num", num, num_p, **TOL_DENSE)
            elif kernel == "K8":
                m = tgd.win_fused_plain(band, el, er, m_other, feat, 0.2, spec)[2]
                gnum = torch.randn(feat.shape, device=dev, generator=gen).to(dtype)
                gden = torch.randn(el.shape, device=dev, generator=gen)
                args = (band, el, er, m, feat, gnum, gden, 0.2, spec)

                def call(a=args):
                    return tgd.win_der(*a)

                def check(chk, name, call=call, a=args):
                    chk.close(f"K8 {name} d_er", call(), tgd.win_der_plain(*a), **TOL_DENSE_T)
            else:
                m = tgd.win_fused_plain(band, el, er, m_other, feat, 0.2, spec)[2]
                gnum = torch.randn(feat.shape, device=dev, generator=gen).to(dtype)
                gden = torch.randn(el.shape, device=dev, generator=gen)
                args = (g.band.bwd, el, er, m, feat, gnum, gden, 0.2, spec)

                def call(a=args):
                    return tgd.win_dsend(*a)

                def check(chk, name, call=call, a=args):
                    d_el, d_feat = call()
                    d_el_p, d_feat_p = tgd.win_dsend_plain(*a)
                    chk.close(f"K9 {name} d_el", d_el, d_el_p, **TOL_DENSE_T)
                    chk.close(f"K9 {name} d_feat", d_feat, d_feat_p, **TOL_DENSE)
        cases[key] = (call, check)
    return cases


def phase_kernel_forms(dev, n, iters, kernels):
    """`--kernel-forms` (card only): builds each form of `KERNEL_FORMS` of the
    named kernels with `nvcc` (all at once) into the git-ignored build
    directory, checks each against the plain version at 3x128 bf16, and
    times it in turns (the forms, then again in reverse order) on phase
    25/29's inputs, as one JSON line beside the card's name and power limit."""
    import ctypes

    out = os.path.join(ROOT, PKG, "build", "kernel_forms")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out, exist_ok=True)
    procs = {k: [_build_form(KERNEL_FORMS[k][0], consts, out, f"{k}_{i}")
                 for i, (_, consts, _) in enumerate(KERNEL_FORMS[k][1])] for k in kernels}
    libs = {}
    for k, built in procs.items():
        libs[k] = []
        for so, proc in built:
            if proc.wait() != 0:
                raise RuntimeError(f"nvcc failed for {so}:\n{proc.stdout.read()}")
            lib = ctypes.CDLL(so)
            for fn, argtypes in _build._SIGNATURES[KERNEL_FORMS[k][0]].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            libs[k].append(lib)
    g, _ = revgat_graph(n, dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    if "K1" in kernels:
        gm, _ = main_graph(n, dev)
        gb, _, _ = band_graph(n, dev)
        k1 = k1_inputs(gm, {"band": (gb.band.fwd.lo_row_ptr, gb.band.fwd.lo_src),
                            "gat": (g.band.fwd.lo_row_ptr, g.band.fwd.n_lo)}, gen)
        del gm, gb
    chk = Checks("kernel forms")
    res, dev_res = {}, {}
    for k in kernels:
        src, forms = KERNEL_FORMS[k]
        module = tsp if k in ("K5", "K6", "K1") else tgd
        # K1's forms must keep every output bit for bit: each is checked at
        # every shape; the others at 3x128 bf16. K1's narrow shapes take
        # less device time than a launch, so its device times go beside.
        cases = _k1_form_cases(k1) if k == "K1" else _form_cases(k, g, gen)
        res[k] = {name: {key: [] for key in cases} for name, _, _ in forms}
        if k == "K1":
            dev_res[k] = {name: {key: [] for key in cases} for name, _, _ in forms}
        order = list(range(len(forms)))
        for i in order + order[::-1]:
            name, _, attrs = forms[i]
            saved = {a: getattr(module, a) for a in attrs}
            _build._libs[src] = libs[k][i]
            try:
                for a, v in attrs.items():
                    setattr(module, a, v)
                for key, (call, check) in cases.items():
                    if (k == "K1" or key == "3x128 bf16") and not res[k][name][key]:
                        check(chk, f"{name} {key}")
                    res[k][name][key].append(time_fn(call, dev, iters))
                    if k == "K1":
                        dev_res[k][name][key].append(device_ms(call, dev, iters))
            finally:
                _build._libs.pop(src, None)
                for a, v in saved.items():
                    setattr(module, a, v)
        del cases
    chk.raise_if_failed()
    log(json.dumps({"card": CARD, "kernel_forms_ms": res, "kernel_forms_device_ms": dev_res}))


def kernel_forms_arg(argv):
    """The kernels of `--kernel-forms[=K8,K6]` (all of `KERNEL_FORMS` when
    none is named), or of its older spelling `--k7-forms`; [] without it."""
    for a in argv:
        if a == "--k7-forms":
            return ["K7"]
        if a == "--kernel-forms":
            return list(KERNEL_FORMS)
        if a.startswith("--kernel-forms="):
            names = a.split("=", 1)[1].split(",")
            unknown = [k for k in names if k not in KERNEL_FORMS]
            if unknown:
                raise SystemExit(f"--kernel-forms: no forms for {unknown}; "
                                 f"known: {list(KERNEL_FORMS)}")
            return names
    return []



# DeeperGCN's graph- and link-level OGB apps, float32 as they run

# the apps' configurations driven on the card (`--rehearse-cpu` cuts depth
# and sizes): (tag, app, test script, argv, timed steps, checkpoint epochs)
OGB_PRODUCTS_NODES = 2_449_029   # ogbn-products' node count
OGB_COLLAB_NODES = 235_868       # ogbl-collab's node count


def ogb_configs(rehearse):
    small = ["--num_layers", "3"] if rehearse else []
    return [
        ("molhiv-dyresgen-7", ogbg_mol, ogbg_mol_test, ["--learn_t"] + small, 3, 2),
        ("molpcba-resgen-14-vn", ogbg_mol, ogbg_mol_test,
         ["--num_layers", "3" if rehearse else "14", "--add_virtual_node",
          "--num_tasks", "128"], 2, 1),
        ("ppa-resgen-28", ogbg_ppa, ogbg_ppa_test, ["--num_layers", "3" if rehearse else "28"],
         3, 1),
    ]


def ogb_graphs(dev, rehearse):
    """The OGB apps' kernel inputs, float32: a 32-molecule batch of ogbg-mol's
    data (N_pad 1024, E_pad 3072) with a BondEncoder's embeddings at C=256 in
    both edge orders (padded edges carry attribute 0: real table rows), a
    16-graph batch of ogbg-ppa's with Linear(7, 128) edge embeddings, and
    ogbl-collab's SBM at its node count without edge features."""
    from deep_gcns_torch_tpu_torch.nn.core import MultiEmbedding

    out = {}
    args = ogbg_mol.get_args(["--synthetic"])
    tr, te = ogbg_mol.load_mol(args, np.random.default_rng(0))
    g, _ = ogbg_mol.make_batcher(32, tr + te)(tr[:32])
    g = g.to(dev)
    enc = MultiEmbedding(BOND_FEATURE_DIMS, 256, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        enc = enc.to(dev)
        out["mol"] = (g, enc(g.edge_attr).contiguous(), enc(g.edge_attr_csc).contiguous())
    args = ogbg_ppa.get_args(["--synthetic"])
    tr, te = ogbg_ppa.load_ppa(args, np.random.default_rng(0))
    g, _ = ogbg_mol.make_batcher(16, tr + te, ogbg_ppa.label)(tr[:16])
    g = g.to(dev)
    lin = Linear(7, 128, generator=torch.Generator().manual_seed(0)).to(dev)
    with torch.no_grad():
        out["ppa"] = (g, lin(g.edge_attr).contiguous(), lin(g.edge_attr_csc).contiguous())
    args = ogbl_collab.get_args(["--synthetic", "--synthetic_nodes",
                                 "2000" if rehearse else str(OGB_COLLAB_NODES)])
    t0 = time.time()
    out["collab"] = (ogbl_collab.load_data(args, np.random.default_rng(0))[0].to(dev), None,
                     None)
    for k, (g, ee, _) in out.items():
        log(f"[ogb-graphs] {k}: N={g.n_node} E={g.n_edge} N_pad={g.num_nodes_padded} "
            f"E_pad={g.num_edges_padded} edge embeddings "
            f"{None if ee is None else tuple(ee.shape)}")
    log(f"[ogb-graphs] collab SBM built in {time.time() - t0:.1f}s (host)")
    return out


# (key, graph, C, kernel): the shapes the OGB apps give the kernels
OGB_SHAPES = (("K2 ee C=256 f32", "mol", 256, "K2 ee"), ("K4 C=256 f32", "mol", 256, "K4"),
              ("K4 dt C=256 f32", "mol", 256, "K4 dt"), ("K2 ee C=128 f32", "ppa", 128, "K2 ee"),
              ("K4 C=128 f32", "ppa", 128, "K4"), ("K2 C=64 f32", "collab", 64, "K2"),
              ("K1 gather C=64 f32", "collab", 64, "K1"))


def ogb_call(graphs, key, gen):
    """(kernel call, plain call, inputs) of one `OGB_SHAPES` entry."""
    _, name, c, kernel = next(s for s in OGB_SHAPES if s[0] == key)
    g, ee, ee_csc = graphs[name]
    dev = g.senders.device
    x = torch.randn(g.num_nodes_padded, c, device=dev, generator=gen)
    if kernel == "K1":  # the gathered form: Aᵀq over the CSC ranges
        return tsp.csr_seg_sum, tsp.csr_seg_sum_plain, (x, g.csc_col_ptr, g.csc_receivers)
    t = torch.tensor([1.0], device=dev)
    if kernel in ("K2", "K2 ee"):
        args = (x, g.senders, g.row_ptr, g.row_order, t, 1e-7, ee)
        return tsp.softmax_agg, tsp.softmax_agg_plain, args
    q = torch.randn(g.num_nodes_padded, c, device=dev, generator=gen)
    gw = kernel == "K4 dt"
    out, lse = tsp.softmax_agg_plain(x, g.senders, g.row_ptr, g.row_order, t, 1e-7, ee)
    if gw:
        q = torch.cat([q, out], 1).contiguous()
    args = (x, ee_csc, q, lse, g.csc_col_ptr, g.csc_order, g.csc_receivers, t, 1e-7, gw)
    return tsp.softmax_bwd_csc, tsp.softmax_bwd_csc_plain, args


def phase_ogb_kernels(graphs):
    """Each `OGB_SHAPES` entry against its plain version in float32 (K4's
    d(ee) padding rows exact 0, dt within TOL_DT), two launches bit for bit;
    and the fused Function with the BondEncoder's embeddings at C=256, with
    learned t, forward and backward against the Function on the plain
    versions."""
    chk = Checks("ogb kernels")
    dev = graphs["mol"][0].senders.device
    gen = torch.Generator(device=dev).manual_seed(12)
    errs = {}
    for key, name, _, kernel in OGB_SHAPES:
        fn, plain, args = ogb_call(graphs, key, gen)
        got, want = fn(*args), plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = 0.0
        for i, (a, b) in enumerate(zip(got, want)):
            if a is None and b is None:
                continue
            tol = TOL_DT["f32"] if kernel == "K4 dt" and i == 2 else TOL_F32
            err = max(err, chk.close(f"{key} output {i}", a, b, **tol))
        if kernel.startswith("K4"):
            n_edge = graphs[name][0].n_edge
            chk.close(f"{key} dee padding rows", got[1][n_edge:], want[1][n_edge:], 0.0, 0.0)
        again = fn(*args)
        again = again if isinstance(again, tuple) else (again,)
        for i, (a, b) in enumerate(zip(again, got)):
            if a is not None:
                chk.equal(f"{key} two launches bit for bit (output {i})", a, b)
        errs[key] = err
        del got, want, again, args
    g, ee, ee_csc = graphs["mol"]
    x = torch.randn(g.num_nodes_padded, 256, device=dev, generator=gen)
    co = torch.randn(g.num_nodes_padded, 256, device=dev, generator=gen)
    res = []
    for fn in (tsp.fused_softmax_gather_agg, tsp.fused_softmax_gather_agg_plain):
        xx = x.clone().requires_grad_(True)
        ec = ee_csc.clone().requires_grad_(True)
        tt = torch.tensor([1.0], device=dev, requires_grad=True)
        o = fn(xx, g.senders, g.row_ptr, g.row_order, g.csc_receivers, g.csc_col_ptr,
               g.csc_order, tt, ee=ee, ee_csc=ec, eps=1e-7, grad_weights=True)
        (o * co).sum().backward()
        res.append((o.detach(), xx.grad, ec.grad, tt.grad))
    for i, part in enumerate(("out", "dx", "d(ee_csc)")):
        chk.close(f"fused ee learn_t C=256 f32 {part}", res[0][i], res[1][i], **TOL_F32)
    chk.close("fused ee learn_t C=256 f32 dt", res[0][3], res[1][3], **TOL_DT["f32"])
    sync(dev)
    chk.raise_if_failed()
    log(f"[ogb-kernels] max errors {errs}")
    return errs


def phase_ogb_agreement(dev, graphs):
    """A small model of each OGB app on the card against the same weights on
    the CPU, outputs and every gradient (3 layers, C=64): ogbg-mol's
    (AtomEncoder, a BondEncoder in every layer, learned t, the virtual node,
    mean pooling) on the 32-molecule batch, ogbg-ppa's (one-time Linear edge
    encoder, softmax_sg t=0.01, mean pooling) on the 16-graph batch,
    ogbl-collab's objective (encoder and LinkPredictor, pos/neg log loss) on
    a 3,000-node SBM and ogbn-products' (node level, softmax_sg t=0.1, 47
    classes, 100 features) on a 3,000-node SBM."""
    chk = Checks("ogb agreement")
    g_mol, g_ppa = graphs["mol"][0].to("cpu"), graphs["ppa"][0].to("cpu")
    small = dict(hidden_channels=64, num_layers=3, final_relu=False)
    cfg_mol = DeeperGCNConfig(in_channels=0, num_tasks=1, aggr="softmax", learn_t=True,
                              node_encoder="atom", atom_feature_dims=ATOM_FEATURE_DIMS,
                              edge_mode="bond", bond_feature_dims=BOND_FEATURE_DIMS,
                              add_virtual_node=True, graph_pooling="mean", **small)
    cfg_ppa = DeeperGCNConfig(in_channels=7, num_tasks=37, aggr="softmax_sg", t=0.01,
                              edge_mode="one_time", edge_feat_dim=7, graph_pooling="mean",
                              **small)
    cfg_prod = DeeperGCNConfig(in_channels=100, num_tasks=47, aggr="softmax_sg", t=0.1,
                               hidden_channels=64, num_layers=3)
    args = ogbl_collab.get_args(["--synthetic", "--synthetic_nodes", "3000"])
    g_col, train_pos, _, n, in_dim = ogbl_collab.load_data(args, np.random.default_rng(0))
    rng = np.random.default_rng(1)
    sel = rng.integers(0, len(train_pos[0]), 1024)
    pos = (torch.from_numpy(train_pos[0][sel]), torch.from_numpy(train_pos[1][sel]))
    neg = (torch.from_numpy(rng.integers(0, n, 1024)), torch.from_numpy(rng.integers(0, n, 1024)))
    args_p = ogbn_products.get_args(["--synthetic", "--synthetic_nodes", "3000"])
    x_p, s_p, r_p = ogbn_products.load_data(args_p, np.random.default_rng(0))[:3]
    g_prod = build_graph(x_p, s_p, r_p, num_nodes=x_p.shape[0])

    def node_level(g):
        def run(model, d):
            gd = g.to(d)
            out = model(gd.x, gd)
            (out * out.detach()).sum().backward()
            return out
        return run

    def collab(models, d):
        gd = g_col.to(d)
        h = models["model"](gd.x, gd)
        p = models["predictor"](h[pos[0].to(d)], h[pos[1].to(d)])
        q = models["predictor"](h[neg[0].to(d)], h[neg[1].to(d)])
        loss = -torch.log(p + 1e-15).mean() - torch.log(1 - q + 1e-15).mean()
        loss.backward()
        return loss

    def seeded(cfg):
        return lambda: DeeperGCN(cfg, generator=torch.Generator().manual_seed(0))

    for name, build, run in (
            ("mol", seeded(cfg_mol), node_level(g_mol)),
            ("ppa", seeded(cfg_ppa), node_level(g_ppa)),
            ("collab", lambda: ogbl_collab.build_models(args, in_dim,
                                                        torch.Generator().manual_seed(0)),
             collab),
            ("products", seeded(cfg_prod), node_level(g_prod))):
        outs = []
        for d in (dev, torch.device("cpu")):
            model = build().to(d)
            model.train()
            out = run(model, d)
            outs.append((out.detach().cpu(), {k: p.grad.detach().cpu()
                                              for k, p in model.named_parameters()}))
        # float32 through 3 layers: summation order in the kernels, BatchNorm,
        # pooling and matmuls; the gradients' floor is the largest gradient's
        chk.close(f"small {name} output, card vs cpu", outs[0][0], outs[1][0], 1e-4, 1e-4)
        g_max = max(float(v.abs().max()) for v in outs[1][1].values())
        for k in outs[1][1]:
            chk.close(f"small {name} grad {k}", outs[0][1][k], outs[1][1][k], 1e-3, 1e-4,
                      ref_max=g_max)
    chk.raise_if_failed()


def _peak(dev):
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None


def _path_info(tag, dev, losses, times, score_s, launches, want, extra=None):
    """Checks finite losses and exact launches; prints and returns the
    path's step times, scoring time, peak and launches beside the card."""
    log(f"[{tag}] losses {losses}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{tag}: loss is not finite")
    log(f"[{tag}] launches {launches} expected {want}")
    if launches != want:
        raise AssertionError(f"{tag}: kernel launches {launches} != expected {want}")
    info = {"step_ms_median": sorted(times)[len(times) // 2] * 1e3,
            "step_ms_all": [v * 1e3 for v in times], "score_ms": score_s * 1e3,
            "max_memory_allocated_bytes": _peak(dev), "launches": launches, **(extra or {})}
    log(f"[{tag}] {json.dumps(info)}; card: {CARD}")
    return info


def _graph_app_expected(dev, model, steps, score_batches):
    """ogbg apps: K2 with `ee` once a layer in every forward (steps + 1
    training batches and the scoring pass's batches), K4 once a layer in
    every backward, K11 in each res+ prologue (`k11_expected`); nothing else
    launches."""
    want = no_launches()
    if dev.type == "cuda":
        layers, forwards = model.cfg.num_layers, steps + 1 + score_batches
        want.update({"K2 ee": layers * forwards, "K4": layers * (steps + 1)})
        want.update(k11_expected(model, forwards, steps + 1))
    return want


def phase_ogb_graph_app(dev, tag, app, test_app, argv, steps, epochs):
    """An ogbg app at full width from seed 0: its own data and batcher, one
    warm-up batch and ``steps`` timed ones through its `train_step`, a timed
    scoring pass over the test molecules (`predict_all`, the test script's
    pass), exact launches, finite losses; then `main` with `--save_ckpt` for
    ``epochs`` epochs and the test script on its `ckpt_best`, whose score
    must equal the best the run printed."""
    base = ["--synthetic", "--device", dev.type] + argv
    args = app.get_args(base)
    rng = np.random.default_rng(args.seed)
    loader = ogbg_mol.load_mol if app is ogbg_mol else ogbg_ppa.load_ppa
    label = (lambda g: g["y"]) if app is ogbg_mol else ogbg_ppa.label
    train_gs, test_gs = loader(args, rng)
    B = args.batch_size
    make_batch = ogbg_mol.make_batcher(B, train_gs + test_gs, label)
    model = app.build_model(args, torch.Generator().manual_seed(0)).to(dev)
    opt = make_optimizer(args.optimizer, model.parameters(), args.lr, args.weight_decay)
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [make_batch(train_gs[i * B:(i + 1) * B]) for i in range(steps + 1)]
    batches = [(g.to(dev), y.to(dev)) for g, y in batches]
    g0 = batches[0][0]
    log(f"[{tag}] {args.num_layers} layers, C={args.hidden_channels}, batch {B}: "
        f"N_pad={g0.num_nodes_padded} E_pad={g0.num_edges_padded} (first batch N={g0.n_node} "
        f"E={g0.n_edge}), {len(train_gs)} training and {len(test_gs)} test graphs")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    step = ((lambda g, y: ogbg_mol.train_step(model, opt, g, y, gen, args.grad_clip))
            if app is ogbg_mol else (lambda g, y: ogbg_ppa.train_step(model, opt, g, y, gen)))
    reset_launches()
    losses, times = [float(step(*batches[0]))], []
    for g, y in batches[1:]:
        t0 = time.perf_counter()
        loss = step(g, y)
        sync(dev)
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    t0 = time.perf_counter()
    preds, ys = ogbg_mol.predict_all(model, test_gs, B, make_batch, dev, app.predict)
    score_s = time.perf_counter() - t0
    launches = read_launches()
    if not np.isfinite(preds).all() or preds.shape[0] != len(test_gs):
        raise AssertionError(f"{tag}: scoring gave {preds.shape}, finite "
                             f"{bool(np.isfinite(preds).all())}")
    info = _path_info(tag, dev, losses, times, score_s, launches,
                      _graph_app_expected(dev, model, steps, -(-len(test_gs) // B)))
    phase_profile(dev, lambda: step(*batches[1]), tag=f"{tag}-profile")
    del batches, model, opt
    free_memory(dev)
    t0 = time.time()
    res = app.main(base + ["--epochs", str(epochs), "--save_ckpt", "--exp_root", RUNS])
    t1 = time.time()
    reset_launches()
    scored = test_app.main(base + ["--pretrained_model", os.path.join(res["exp"], "ckpt_best")])
    launches = read_launches()
    got = scored["score"] if app is ogbg_mol else scored["acc"]
    log(f"[{tag}-ckpt] run {res}; test script {got} (epoch {scored['meta']['epoch']}), "
        f"launches {launches}; train {t1 - t0:.1f}s, score {time.time() - t1:.1f}s; card: {CARD}")
    if got != res["best"] or not all(map(math.isfinite, res["losses"])):
        raise AssertionError(f"{tag}: the test script scored {got}, the run's best "
                             f"{res['best']}")
    free_memory(dev)
    return info


def phase_ogb_collab(dev, steps, rehearse):
    """ogbl-collab at the app's defaults (3 layers, C=64, softmax, batches of
    8,192 edges) on its SBM at ogbl-collab's node count: one warm-up and
    ``steps`` timed updates through `train_step`, a timed Hits@50 pass
    (`hits`: one encoder forward, the held-out positives and the fixed
    negatives); K2 3 a forward, K1 3 a backward; then `main` with
    `--save_ckpt` for one epoch and the test script, whose Hits@50 must equal
    the run's."""
    base = ["--synthetic", "--device", dev.type, "--synthetic_nodes",
            "2000" if rehearse else str(OGB_COLLAB_NODES)]
    args = ogbl_collab.get_args(base)
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    g, train_pos, val_pos, n, in_dim = ogbl_collab.load_data(args, rng)
    val_neg = ogbl_collab.eval_negatives(rng, n, len(val_pos[0]))
    host_s = time.time() - t0
    g = g.to(dev)
    models = ogbl_collab.build_models(args, in_dim, torch.Generator().manual_seed(0)).to(dev)
    opt = make_optimizer(args.optimizer, models.parameters(), args.lr)
    gen = torch.Generator(device=dev).manual_seed(1)
    be = min(args.batch_edges, len(train_pos[0]))
    draws = []
    for _ in range(steps + 1):
        sel = rng.integers(0, len(train_pos[0]), be)
        draws.append(((train_pos[0][sel], train_pos[1][sel]),
                      (rng.integers(0, n, be), rng.integers(0, n, be))))
    draws = [tuple(tuple(torch.from_numpy(a).to(dev) for a in pair) for pair in d)
             for d in draws]
    log(f"[ogbl-collab] N={g.n_node} E={g.n_edge} N_pad={g.num_nodes_padded} "
        f"E_pad={g.num_edges_padded}, {len(train_pos[0])} training and {len(val_pos[0])} "
        f"held-out edges, SBM built in {host_s:.1f}s (host)")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    losses = [float(ogbl_collab.train_step(models, opt, g, *draws[0], gen))]
    times = []
    for d in draws[1:]:
        t0 = time.perf_counter()
        loss = ogbl_collab.train_step(models, opt, g, *d, gen)
        sync(dev)
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    t0 = time.perf_counter()
    hits = ogbl_collab.hits(args, models, g, val_pos, val_neg, dev)
    score_s = time.perf_counter() - t0
    want = no_launches()
    if dev.type == "cuda":
        want.update(K2=3 * (steps + 2), K4=3 * (steps + 1))
        want.update(k11_expected(models["model"], steps + 2, steps + 1))
    info = _path_info("ogbl-collab", dev, losses, times, score_s, read_launches(), want,
                      {"hits@50": hits})
    phase_profile(dev, lambda: ogbl_collab.train_step(models, opt, g, *draws[1], gen),
                  tag="ogbl-collab-profile")
    del models, opt, g, draws
    free_memory(dev)
    t0 = time.time()
    res = ogbl_collab.main(base + ["--epochs", "1", "--save_ckpt", "--exp_root", RUNS])
    t1 = time.time()
    scored = ogbl_collab_test.main(base + ["--pretrained_model",
                                           os.path.join(res["exp"], "ckpt_best")])
    log(f"[ogbl-collab-ckpt] run {res}; test script {scored['hits']}; train {t1 - t0:.1f}s, "
        f"score {time.time() - t1:.1f}s; card: {CARD}")
    if scored["hits"] != res["best"] or not all(map(math.isfinite, res["losses"])):
        raise AssertionError(f"ogbl-collab: the test script gave {scored['hits']}, the run "
                             f"{res['best']}")
    free_memory(dev)
    return info


def phase_ogb_products(dev, steps, rehearse):
    """ogbn-products' ResGEN-14 (C=128, 47 classes, 100 features, softmax_sg
    t=0.1) on the app's SBM at ogbn-products' node count, 10 random
    clusters: the data built once on the host; one warm-up and ``steps``
    timed cluster steps through `train_step` on a partition of its own, a
    timed `predict` of one evaluation cluster; K2 14 a forward, K1 14 a
    backward; then the app's `train` for one epoch with `--save_ckpt` (10
    cluster steps and the partitioned evaluation) and the test script's
    `score` on the same data, whose accuracies must equal the run's."""
    nodes = 3000 if rehearse else OGB_PRODUCTS_NODES
    base = ["--synthetic", "--device", dev.type, "--synthetic_nodes", str(nodes),
            "--num_layers", "3" if rehearse else "14"]
    args = ogbn_products.get_args(base + ["--epochs", "1", "--save_ckpt", "--exp_root", RUNS])
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    data = ogbn_products.load_data(args, rng)
    host_s = time.time() - t0
    _, senders, _, _, _, in_dim, n = data
    t0 = time.time()
    clusters = ogbn_products.cluster_builder(args, data)
    graphs, _, feats = clusters(random_partition_graph(np.random.default_rng(99), n,
                                                       args.cluster_number), args.cluster_number)
    part_s = time.time() - t0
    g0 = graphs[0]
    log(f"[ogbn-products] N={n} E={len(senders)} built in {host_s:.1f}s, partition into "
        f"{args.cluster_number} clusters in {part_s:.1f}s (host): a cluster N_pad="
        f"{g0.num_nodes_padded} N={g0.n_node} E={g0.n_edge} E_pad={g0.num_edges_padded}")
    model = ogbn_products.build_model(args, in_dim, torch.Generator().manual_seed(0)).to(dev)
    opt = make_optimizer(args.optimizer, model.parameters(), args.lr)
    gen = torch.Generator(device=dev).manual_seed(1)
    inputs = []
    for ci in range(steps + 1):
        g = graphs[ci].to(dev)
        xx, yy, tm = (torch.from_numpy(a).to(dev) for a in feats[ci])
        inputs.append((g, xx, yy[:, 0], (tm[:, 0] > 0) & g.node_mask))
    del graphs, feats
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    losses = [float(ogbn_products.train_step(model, opt, *inputs[0], gen))]
    times = []
    for inp in inputs[1:]:
        t0 = time.perf_counter()
        loss = ogbn_products.train_step(model, opt, *inp, gen)
        sync(dev)
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    t0 = time.perf_counter()
    logits = ogbn_products.predict(model, inputs[0][0], inputs[0][1])
    sync(dev)
    score_s = time.perf_counter() - t0
    if not bool(torch.isfinite(logits).all()) or logits.shape != (g0.num_nodes_padded, 47):
        raise AssertionError(f"ogbn-products: predict gave {tuple(logits.shape)}")
    want = no_launches()
    layers = args.num_layers
    if dev.type == "cuda":
        want.update(K2=layers * (steps + 2), K4=layers * (steps + 1))
        want.update(k11_expected(model, steps + 2, steps + 1))
    info = _path_info("ogbn-products", dev, losses, times, score_s, read_launches(), want,
                      {"nodes": n, "edges": len(senders), "host_build_s": host_s,
                       "partition_s": part_s})
    phase_profile(dev, lambda: ogbn_products.train_step(model, opt, *inputs[1], gen),
                  tag="ogbn-products-profile")
    del model, opt, inputs, logits
    free_memory(dev)
    t0 = time.time()
    res = ogbn_products.train(args, data, rng)
    t1 = time.time()
    best_epoch = max(res["evals"], key=lambda e: res["evals"][e]["valid"])
    scored = ogbn_products_test.score(ogbn_products.get_args(
        base + ["--pretrained_model", os.path.join(res["exp"], "ckpt_best")]), data)
    log(f"[ogbn-products-ckpt] run {res}; test script {scored['accs']}; train {t1 - t0:.1f}s, "
        f"score {time.time() - t1:.1f}s; card: {CARD}")
    if scored["accs"] != res["evals"][best_epoch] or not all(map(math.isfinite,
                                                                 res["losses"])):
        raise AssertionError(f"ogbn-products: the test script gave {scored['accs']}, the run "
                             f"{res['evals'][best_epoch]}")
    free_memory(dev)
    return info


def phase_ogb_timing(graphs, errs, launches, iters):
    """The OGB shapes' times in float32: `time_fn`'s and `device_ms`'s, the
    plain version's, the bound (inputs read once, outputs written once: x,
    the edge embeddings of the real edges, q, the index and pointers; d(ee)
    all E_pad rows; per (edge, channel) 11 float32 operations and one
    accurate `expf` for K2, 13 and one for K4 with dt, 10 and one for K4, one
    add for K1) and, for K1, `torch.sparse.mm` of the count matrix in
    float32. Returns one `kernels` row per shape."""
    dev = graphs["mol"][0].senders.device
    gen = torch.Generator(device=dev).manual_seed(13)
    rows = []
    for key, name, c, kernel in OGB_SHAPES:
        g = graphs[name][0]
        n_pad, e, e_pad = g.num_nodes_padded, g.n_edge, g.num_edges_padded
        fn, plain, args = ogb_call(graphs, key, gen)
        ms = time_fn(lambda: fn(*args), dev, iters)
        d_ms = device_ms(lambda: fn(*args), dev, iters)
        plain_ms = time_fn(lambda: plain(*args), dev, 3)
        idx_b = 4 * e + 4 * (n_pad + 1)
        lib_ms = None
        if kernel == "K1":
            b = bound(2 * n_pad * c * 4 + idx_b, e * c)
            coo = torch.sparse_coo_tensor(
                torch.stack([g.csc_senders[:e].long(), g.csc_receivers[:e].long()]),
                torch.ones(e, device=dev), (n_pad, n_pad)).coalesce().to_sparse_csr()
            q = args[0]
            lib_ms = time_fn(lambda: torch.sparse.mm(coo, q), dev, iters)
            chk = Checks("ogb timing")
            chk.close(f"library yardstick sparse.mm vs {key}", torch.sparse.mm(coo, q),
                      fn(*args), **TOL_LIBRARY)
            chk.raise_if_failed()
        elif kernel.startswith("K2"):
            ee_b = e * c * 4 if kernel == "K2 ee" else 0
            b = bound(n_pad * c * 4 + ee_b + idx_b + 4 * c + 4 + 2 * n_pad * c * 4,
                      (11 if ee_b else 10) * e * c, e * c)
        else:
            qc = 2 * c if kernel == "K4 dt" else c
            b = bound(n_pad * c * 4 + e * c * 4 + n_pad * qc * 4 + idx_b + 4 * c + 4
                      + n_pad * c * 4 + e_pad * c * 4 + (4 * n_pad if qc > c else 0),
                      (13 if qc > c else 10) * e * c, e * c)
        src, line = {"K1": ("seg_sum.cu", 252), "K2": ("softmax_agg.cu", 322),
                     "K2 ee": ("softmax_agg.cu", 322)}.get(kernel, ("softmax_bwd_csc.cu", 466))
        rows.append({"name": f"{key} (ogb {name})",
                     "route": "cuda", "source": f"{PKG}/csrc/{src}",
                     "replaces": f"deep_gcns_torch_tpu/ops/spmm_pallas.py:{line}",
                     "launches": launches[key], "max_abs_err": errs[key], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
                     "library_ms": lib_ms})
        log(f"[ogb-timing] {key} ({name}: N_pad={n_pad} E={e}): {ms:.4f} ms, device "
            f"{d_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}), plain {plain_ms:.3f} ms"
            f"{'' if lib_ms is None else f', torch.sparse.mm {lib_ms:.4f} ms'}; launches on "
            f"its path {launches[key]}; card: {CARD}")
        del args
    log("[ogb-timing] no single PyTorch call computes K2 or K4: their library_ms is null")
    return rows


def phase_ogb(dev, rehearse, iters):
    """Phases 40-46 (the OGB apps); returns the `kernels` rows of their shapes."""
    graphs = ogb_graphs(dev, rehearse)
    errs = phase_ogb_kernels(graphs)
    mark("ogb kernels")
    phase_ogb_agreement(dev, graphs)
    mark("ogb agreement")
    infos = {}
    for tag, app, test_app, argv, steps, epochs in ogb_configs(rehearse):
        infos[tag] = phase_ogb_graph_app(dev, tag, app, test_app, argv, steps, epochs)
        mark(tag)
    infos["ogbl-collab"] = phase_ogb_collab(dev, 3, rehearse)
    mark("ogbl-collab")
    infos["ogbn-products"] = phase_ogb_products(dev, 3, rehearse)
    mark("ogbn-products")
    mol, col = infos["molhiv-dyresgen-7"]["launches"], infos["ogbl-collab"]["launches"]
    pcba, ppa = infos["molpcba-resgen-14-vn"]["launches"], infos["ppa-resgen-28"]["launches"]
    # each shape's launches on the path that gives it: DyResGEN-7 learns t
    # (K4 with dt), ResGEN-14 with the virtual node does not
    launches = {"K2 ee C=256 f32": mol["K2 ee"] + pcba["K2 ee"], "K4 C=256 f32": pcba["K4"],
                "K4 dt C=256 f32": mol["K4"],
                "K2 ee C=128 f32": ppa["K2 ee"], "K4 C=128 f32": ppa["K4"],
                "K2 C=64 f32": col["K2"], "K1 gather C=64 f32": col["K1"]}
    rows = phase_ogb_timing(graphs, errs, launches, iters)
    mark("ogb timing")
    keys = ("step_ms_median", "score_ms", "max_memory_allocated_bytes")
    summary = {k: {kk: v[kk] for kk in keys} for k, v in infos.items()}
    log(f"[ogb] paths: {json.dumps(summary)}; card: {CARD}")
    return rows


# ---------------------------------------------------------------------------
# K2's message form, the unfused GENConv path, PPI, the zoo, RevGCN gcn/sage
# ---------------------------------------------------------------------------

MSGS_WIDTHS = (40, 64, 128, 256)


def _msgs_agg(fn, m, g, t, y, aggr):
    """``aggr`` (softmax_sg, softmax with a learned t, softmax_sum with a
    learned t and y) through the message-form Function ``fn``, scaled as
    `generalized_aggregate` scales softmax_sum."""
    out = fn(m, g.receivers, g.row_ptr, t, aggr != "softmax_sg")
    if aggr == "softmax_sum":
        deg = tseg.segment_degree(g.receivers, g.num_nodes_padded, g.edge_mask,
                                  out.dtype).float()
        out = torch.pow(deg, torch.sigmoid(y))[:, None] * out.float()
    return out


def phase_msgs_kernels(g, corner):
    """K2's message form against its plain version on phase 2's graph and on
    the K2 corner graph, f32 and bf16, C = 40, 64, 128 and 256 (the lane
    groups of the gather forms), messages of either sign with the exact
    shift: rows with no edge exact 0, two launches bit for bit; then the
    Function forward and backward (softmax_sg, learned t, softmax_sum)
    against the Function on the plain version. Returns the largest error of
    each dtype at phase 4's shape (C=128)."""
    dev = g.senders.device
    chk = Checks("msgs kernels")
    gen = torch.Generator(device=dev).manual_seed(21)
    errs = {}
    for gg, where in ((g, "main graph"), (corner, "corner graph")):
        empty = (gg.row_ptr[1:] == gg.row_ptr[:-1]).nonzero()[:, 0]
        for dtype in (torch.float32, torch.bfloat16):
            tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
            tag = "f32" if dtype == torch.float32 else "bf16"
            t = torch.tensor([0.7], device=dev)
            for c in MSGS_WIDTHS:
                m = torch.randn(gg.num_edges_padded, c, device=dev, generator=gen).to(dtype)
                out, lse = tsp.softmax_agg_msgs(m, gg.row_ptr, t)
                out_p, lse_p = tsp.softmax_agg_msgs_plain(m, gg.row_ptr, t)
                name = f"K2 msgs {where} C={c} {tag}"
                e = max(chk.close(f"{name} out", out, out_p, **tol),
                        chk.close(f"{name} lse", lse, lse_p, **TOL_LSE))
                if where == "main graph" and c == 128:
                    errs[tag] = e
                zero = torch.zeros(len(empty), c, dtype=dtype, device=dev)
                chk.equal(f"{name} rows with no edge exact 0 (out)", out[empty], zero)
                chk.equal(f"{name} rows with no edge exact 0 (lse)", lse[empty], zero.float())
                out2, lse2 = tsp.softmax_agg_msgs(m, gg.row_ptr, t)
                chk.equal(f"{name} two launches bit for bit (out)", out2, out)
                chk.equal(f"{name} two launches bit for bit (lse)", lse2, lse)
                del m, out, lse, out_p, lse_p, out2, lse2
        log(f"[msgs kernels] {where}: {len(empty)} rows with no edge")
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
        tol_b = TOL_F32 if dtype == torch.float32 else TOL_BWD_BF16
        tag = "f32" if dtype == torch.float32 else "bf16"
        m0 = torch.randn(g.num_edges_padded, 128, device=dev, generator=gen).to(dtype)
        for aggr in ("softmax_sg", "softmax", "softmax_sum"):
            res = []
            for fn in (tsp.gen_softmax_aggregate_csr, tsp.gen_softmax_aggregate_csr_plain):
                m = m0.clone().requires_grad_(True)
                t = torch.tensor([0.1], device=dev, requires_grad=aggr != "softmax_sg")
                y = torch.tensor([0.3], device=dev, requires_grad=True)
                o = _msgs_agg(fn, m, g, t, y, aggr)
                (o.float() ** 2).sum().backward()
                res.append((o.detach(), m.grad, t.grad, y.grad))
            name = f"message-form Function {aggr} {tag}"
            chk.close(f"{name} out", res[0][0], res[1][0], **tol)
            chk.close(f"{name} d(msgs)", res[0][1], res[1][1], **tol_b)
            if aggr != "softmax_sg":
                chk.close(f"{name} dt", res[0][2], res[1][2], **TOL_DT[tag])
            if aggr == "softmax_sum":
                chk.close(f"{name} dy", res[0][3], res[1][3], **TOL_DT[tag])
            del res
        del m0
    sync(dev)
    chk.raise_if_failed()
    return errs


def phase_unfused_path(g, labels, layers, main_info):
    """ResGEN-28 (phase 4's model, weights and seed) on phase 4's graph
    without its CSC: the unfused branch (a plain gather, relu + ε, K2's
    message form) through the app's `train_step`: one warm-up, 2 timed
    steps and a `predict`, 28 message-form launches a forward and nothing
    else; its step time and peak beside the fused route's (phase 4)."""
    g_unfused = without_csc(g)
    info, state = phase_main_path(g_unfused, labels, layers, 2, tag="unfused-main")
    phase_profile(g.senders.device, arxiv_step(g_unfused, state), tag="unfused-profile")
    del state
    log(f"[unfused-main] unfused/fused step ratio on the same weights: "
        f"{info['step_ms_median'] / main_info['step_ms_median']:.4f} "
        f"({info['step_ms_median']:.3f} / {main_info['step_ms_median']:.3f} ms); peak "
        f"{info.get('max_memory_allocated_bytes')} against "
        f"{main_info.get('max_memory_allocated_bytes')} bytes; card: {CARD}")
    return info


# PyG's PPI: 24 graphs of 2,245 nodes and 61,318 directed edges on average
PPI_NODES, PPI_EDGES = 2245, 61318


def ppi_graphs(count, rehearse):
    """``count`` PPI-shaped graphs from seed 0: 50 features, 121 labels (30 %
    positive), nodes within ±20 % of the mean, uniform random edges at the
    mean degree."""
    rng = np.random.default_rng(0)
    mean_n, mean_e = (200, 2000) if rehearse else (PPI_NODES, PPI_EDGES)
    gs = []
    for _ in range(count):
        n = int(rng.integers(int(0.8 * mean_n), int(1.2 * mean_n)))
        e = int(round(n * mean_e / mean_n))
        gs.append(dict(x=rng.standard_normal((n, 50)).astype(np.float32),
                       senders=rng.integers(0, n, e), receivers=rng.integers(0, n, e),
                       y=(rng.random((n, 121)) < 0.3).astype(np.float32)))
    return gs


def phase_ppi_path(dev, tag, argv, steps, rehearse):
    """A PPI model of the app's flags ``argv`` on PPI-shaped graphs padded by
    the app's batcher, through `apps/ppi`'s `train_step`: one warm-up,
    ``steps`` timed steps, a timed `predict`, K1 2·(blocks − 1) times a step
    (each block's two gathers' backward: the gathered form over the CSC for
    the sender gather, the plain form for the receiver gather; the head's
    input takes no gradient) and never in `predict`, finite losses, the peak
    and a profile of one more step. Returns (info, one padded graph)."""
    args = ppi.get_args(["--device", dev.type] + argv)
    gs = ppi_graphs(steps + 2, rehearse)
    to_batch = ppi.make_batcher(args, gs)
    batches = [(gr.to(dev), y.to(dev)) for gr, y in map(to_batch, gs)]
    g0 = batches[0][0]
    free_memory(dev)
    model = ppi.build_model(args, torch.Generator().manual_seed(0)).to(dev)
    opt = make_optimizer(args.optimizer, model.parameters(), args.lr, args.weight_decay)
    gen = torch.Generator(device=dev).manual_seed(1)
    log(f"[{tag}] {args.n_blocks} blocks x {args.n_filters} ({args.conv}, "
        f"{args.compute_dtype or 'float32'}): N_pad={g0.num_nodes_padded} "
        f"E_pad={g0.num_edges_padded}, graphs of {[int(g.n_node) for g, _ in batches]} nodes "
        f"and {[int(g.n_edge) for g, _ in batches]} edges")

    def step(g, y):
        return ppi.train_step(model, opt, g, y, gen)

    reset_launches()
    losses, times = [float(step(*batches[0]))], []
    for g, y in batches[1:steps + 1]:
        t0 = time.perf_counter()
        loss = step(g, y)
        sync(dev)
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    t0 = time.perf_counter()
    logits = ppi.predict(model, batches[-1][0])
    sync(dev)
    score_s = time.perf_counter() - t0
    launches = read_launches()
    if logits.shape != (g0.num_nodes_padded, 121) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{tag}: predict gave {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    want = no_launches()
    if dev.type == "cuda":
        want.update(K1=2 * (args.n_blocks - 1) * (steps + 1))
    info = _path_info(tag, dev, losses, times, score_s, launches, want,
                      {"n_pad": g0.num_nodes_padded, "e_pad": g0.num_edges_padded})
    phase_profile(dev, lambda: step(*batches[1]), tag=f"{tag}-profile")
    g_keep = batches[1][0]
    del batches, model, opt
    free_memory(dev)
    return info, g_keep


def phase_ppi_app(dev, rehearse):
    """`apps/ppi.main` on its synthetic graphs for 2 epochs with
    `--save_ckpt` (the app's defaults, ResMRGCN-14 x 64), then
    `apps/ppi_test` on `ckpt_best`, whose valid micro-F1 must equal the
    run's best."""
    base = ["--synthetic", "--device", dev.type]
    if rehearse:
        base += ["--n_blocks", "3", "--n_filters", "16"]
    t0 = time.time()
    res = ppi.main(base + ["--epochs", "2", "--save_ckpt", "--exp_root", RUNS])
    t1 = time.time()
    scored = ppi_test.main(base + ["--pretrained_model", os.path.join(res["exp"], "ckpt_best")])
    log(f"[ppi-app] run {res}; test script valid {scored['valid']} test {scored['test']} "
        f"(epoch {scored['meta']['epoch']}); train {t1 - t0:.1f}s, score "
        f"{time.time() - t1:.1f}s; card: {CARD}")
    if scored["valid"] != res["best"] or not all(map(math.isfinite, res["losses"])):
        raise AssertionError(f"ppi-app: the test script scored {scored['valid']}, the run's "
                             f"best {res['best']}")
    free_memory(dev)


ZOO_CONVS = ("edge", "mr", "gat", "gcn", "gin", "sage", "rsage")


def _card_vs_cpu(chk, name, dev, build, run):
    """``run(model, device)`` (which returns the output) on the card and on
    the CPU from the same weights: the output and every gradient, float32,
    summation order only (phase 3's tolerances)."""
    outs = []
    for d in (dev, torch.device("cpu")):
        model = build().to(d)
        model.train()
        out = run(model, d)
        outs.append((out.detach().cpu(),
                     {k: p.grad.detach().cpu() for k, p in model.named_parameters()
                      if p.grad is not None}))
    chk.close(f"{name} output, card vs cpu", outs[0][0], outs[1][0], 1e-4, 1e-4)
    g_max = max(float(v.abs().max()) for v in outs[1][1].values())
    for k in outs[1][1]:
        chk.close(f"{name} grad {k}", outs[0][1][k], outs[1][1][k], 1e-3, 1e-4, ref_max=g_max)


def phase_zoo_agreement(dev):
    """A 3-block `DeepGCNStatic` of each conv and each block kind on the card
    against the same weights on the CPU: the logits of the whole model, then
    each graph layer (the head conv and each block) on the same input (the
    CPU's) under a random cotangent: its output, the input's gradient (the
    gathers' backward: K1) and every parameter gradient. Whole-model
    gradients are not compared: relu and the maxima are kinks, and the two
    devices' rounding differences move some pre-activation across one among
    the head's millions (3000 nodes x 1,792 MLP channels); on the CPU alone
    a 1e-6 relative perturbation of x moved the whole model's gradients by
    up to 1.5e-2 of the largest, and a layer's by more than 1e-4 in 2 of the
    63 layers (EdgeConv's edge-wise MLP and max). A layer's input is the
    same on both sides, so MRConv's max over x_j − x_i picks the same edges;
    EdgeConv's max over its MLP's messages may not, so the cotangent is 0 at
    its near ties (`utils.agreement.layer_results`, shared with the card
    tests). The fusion and prediction MLPs hold no graph op."""
    chk = Checks("zoo agreement")
    cpu = torch.device("cpu")
    gc, _ = random_node_graph(np.random.default_rng(4), 1000, 10, 32, num_classes=7,
                              self_loops=True)
    gd = gc.to(dev)
    gen = torch.Generator().manual_seed(5)
    reset_launches()
    for block in ("res", "dense", "plain"):
        for conv in ZOO_CONVS:
            cfg = DeepGCNConfig(in_channels=32, n_classes=7, n_filters=32, n_blocks=3,
                                conv=conv, block=block, heads=4 if conv == "gat" else 1,
                                dropout=0.0)
            models = [DeepGCNStatic(cfg, torch.Generator().manual_seed(0)).to(d).train()
                      for d in (dev, cpu)]
            name = f"DeepGCNStatic {block} {conv}"
            with torch.no_grad():
                logits = [m(g.x, g) for m, g in zip(models, (gd, gc))]
            chk.close(f"{name} logits, card vs cpu", logits[0][:gc.n_node].cpu(),
                      logits[1][:gc.n_node], 1e-4, 1e-4)
            for lname, outs in layer_results(models, (gd, gc), conv, block, gen):
                tag = f"{name} {lname}"
                chk.close(f"{tag} output", outs[0][0][:gc.n_node], outs[1][0][:gc.n_node],
                          1e-4, 1e-4)
                chk.close(f"{tag} input grad", outs[0][1], outs[1][1], 1e-3, 1e-4)
                g_max = max(float(v.abs().max()) for v in outs[1][2].values())
                for k in outs[1][2]:
                    chk.close(f"{tag} grad {k}", outs[0][2][k], outs[1][2][k], 1e-3, 1e-4,
                              ref_max=g_max)
    launches = read_launches()
    log(f"[zoo agreement] launches on the card {launches}")
    if dev.type == "cuda" and launches["K1"] == 0:
        raise AssertionError("zoo agreement: K1 never launched")
    chk.raise_if_failed()


def hub_free_band_graph(n, dev):
    """A random graph of bandwidth 64 (each receiver within ±64 of its
    sender, degree 10) with 0.5 % random edges for a leftover, its band
    built with the window "auto" and no hubs: what `band_extreme_ok` takes."""
    rng = np.random.default_rng(6)
    e = n * 10
    s = rng.integers(0, n, e)
    r = np.clip(s + rng.integers(-64, 65, e), 0, n - 1)
    cross = rng.random(e) < 0.005
    r[cross] = rng.integers(0, n, int(cross.sum()))
    g = attach_band(build_graph(rng.standard_normal((n, 32)).astype(np.float32), s, r,
                                num_nodes=n), "auto", None)
    f = g.band.fwd
    log(f"[zoo band] hub-free graph N={g.n_node} E={g.n_edge}: window {f.window}, coverage "
        f"{f.coverage:.4f}, leftover {f.n_lo}")
    return g


def extreme_routes(chk, name, g_host, dev, c, dtype, iters):
    """A max of x over each receiver's senders on ``g_host`` moved to
    ``dev``, forward and backward: `band_extreme` (the masked window reduce
    and its tie-splitting gather) against the path MRConv and GENConv take
    without it (`gather_src_auto`, then the segment max, whose gather's
    backward is K1 over the CSC). Both are exact maxima with the same tie
    rule: the outputs must be equal, the gradients close (their sums run in
    another order; in bf16 the shares of a tie round apart,
    `TOL_TIES_BF16`). Returns (window ms, scatter ms)."""
    gd = g_host.to(dev)
    gen = torch.Generator(device=dev).manual_seed(8)
    n = gd.num_nodes_padded
    x = torch.randn(n, c, device=dev, generator=gen).to(dtype).requires_grad_(True)
    co = torch.randn(n, c, device=dev, generator=gen).to(dtype)

    def window():
        x.grad = None
        out = tband.band_extreme(x, gd.band, gd.senders, gd.receivers, gd.edge_mask, "max")
        (out * co).sum().backward()
        return out

    def scatter():
        x.grad = None
        out = tseg.segment_max(gather_src_auto(x, gd), gd.receivers, n, gd.edge_mask)
        (out * co).sum().backward()
        return out

    res = [(fn().detach(), x.grad.clone()) for fn in (window, scatter)]
    chk.equal(f"{name} band_extreme = gather + segment max", res[0][0], res[1][0])
    tol = TOL_F32 if dtype == torch.float32 else TOL_TIES_BF16
    chk.close(f"{name} band_extreme grad", res[0][1], res[1][1], **tol)
    return time_fn(window, dev, iters), time_fn(scatter, dev, iters)


def phase_extreme_timing(free, dev, rehearse, iters):
    """`band_extreme` against the gather + segment max on the card at PPI's
    widths (C=64 float32, C=256 bf16), on the hub-free graph and on one
    PPI-shaped graph whose band is forced to a 256-row window (uniform
    random edges: its coverage is far below the gate's 0.98, which refuses
    it; the leftover runs through the segment max): the same values, and
    the times that keep the card off `band_extreme` (`band_extreme_route`)."""
    chk = Checks("band extreme")
    d = ppi_graphs(1, rehearse)[0]
    ppi_g = attach_band(build_graph(d["x"], d["senders"], d["receivers"],
                                    num_nodes=d["x"].shape[0]), 256, None)
    for name, g in (("hub-free", free), ("PPI-shaped", ppi_g)):
        f = g.band.fwd
        for c, dtype in ((64, torch.float32), (256, torch.bfloat16)):
            tag = f"{name} C={c} {str(dtype)[6:]}"
            w_ms, s_ms = extreme_routes(chk, tag, g, dev, c, dtype, iters)
            log(f"[zoo band] max over senders fwd+bwd, {name} N={g.n_node} E={g.n_edge} "
                f"(window {f.window}, coverage {f.coverage:.4f}, gate "
                f"{tband.band_extreme_ok(g)}), C={c} {str(dtype)[6:]}: window reduce "
                f"{w_ms} ms, gather + segment max {s_ms} ms, ratio {w_ms / s_ms}; card: {CARD}")
    chk.raise_if_failed()


def phase_zoo_band(gb, dev, n_free):
    """The zoo's band routes, card against CPU: SemiGCN, GIN and SAGE (plain
    and relative) through `band_sum_auto` on phase 7's band graph (K3 must
    launch: `band_sum_ok` holds there); MRConv and GENConv max/min on a
    hub-free graph where `band_extreme_ok` holds (phase 7's has hubs and is
    refused): `band_extreme` on the CPU, the gather + segment max on the
    card (`band_extreme_route`); no route miss may be counted. Returns the
    hub-free graph."""
    chk = Checks("zoo band")
    gcpu = gb.to("cpu")
    free = hub_free_band_graph(n_free, dev)
    if not tband.band_sum_ok(gb):
        raise AssertionError("zoo band: band_sum_ok refused phase 7's graph")
    if tband.band_extreme_ok(gcpu) or not tband.band_extreme_ok(free):
        raise AssertionError("zoo band: band_extreme_ok should refuse phase 7's graph (hubs) "
                             "and take the hub-free one")
    misses = tseg.fastpath_misses()
    gen = torch.Generator().manual_seed(7)
    x_b = torch.randn(gb.num_nodes_padded, 32, generator=gen)
    co_b = torch.randn(gb.num_nodes_padded, 32, generator=gen)
    co_b[gb.n_node:] = 0.0
    co_f = torch.randn(free.num_nodes_padded, 32, generator=gen)
    co_f[free.n_node:] = 0.0

    def seeded():
        return torch.Generator().manual_seed(0)

    cases = [(c, gcpu, x_b, co_b,
              lambda c=c: graph_conv(32, 32, c, norm="batch", generator=seeded()))
             for c in ("gcn", "gin", "sage", "rsage")]
    cases.append(("mr", free, free.x, co_f,
                  lambda: graph_conv(32, 32, "mr", norm="batch", generator=seeded())))
    cases += [(f"gen-{a}", free, free.x, co_f,
               lambda a=a: GENConv(32, 32, aggr=a, norm="batch", generator=seeded()))
              for a in ("max", "min")]
    for name, g_host, x, co, build in cases:
        reset_launches()

        def run(model, d, g_host=g_host, x=x, co=co):
            gd = g_host.to(d)
            xd = x.to(d).clone().requires_grad_(True)
            out = model(xd, gd)
            (out * co.to(d)).sum().backward()
            return torch.cat([out[:gd.n_node], xd.grad[:gd.n_node]], 1)

        _card_vs_cpu(chk, f"band route {name}", dev, build, run)
        launches = read_launches()
        log(f"[zoo band] {name}: launches on the card {launches}")
        if dev.type == "cuda" and g_host is gcpu and launches["K3"] == 0:
            raise AssertionError(f"zoo band: {name} did not launch K3")
    if tseg.fastpath_misses() != misses:
        raise AssertionError(f"zoo band: a route was refused: {tseg.fastpath_misses()}")
    chk.raise_if_failed()
    log(f"[zoo band] card: {CARD}")
    return free


def rev_zoo_app(conv):
    """`apps/ogbn_proteins_rev` with its model's group function ``conv``
    ("gcn" or "sage"; the app's flags otherwise)."""

    def build_model(args, generator=None):
        return RevGCN(RevGCNConfig(
            in_channels=8, node_feat_dim=8, edge_feat_dim=8,
            hidden_channels=args.hidden_channels, num_tasks=args.num_tasks,
            num_layers=args.num_layers, group=args.group, norm=args.norm,
            dropout=args.dropout, use_one_hot_encoding=args.use_one_hot_encoding, conv=conv),
            generator=generator)

    return SimpleNamespace(get_args=ogbn_proteins_rev.get_args, build_model=build_model,
                           train_step=ogbn_proteins_rev.train_step,
                           predict=ogbn_proteins_rev.predict)


def rev_k1_expected(group):
    """RevGCN with GCN or SAGE group functions: each evaluation of a group
    function sums its messages with K1 (the plain CSR form); a train step
    evaluates each once in the forward and once in the backward's fused
    inverse+VJP, whose gather backward is K1's gathered form; `predict`
    once."""
    def want(layers, n):
        lg = layers * group
        out = no_launches()
        out.update(K1=3 * lg * n + lg)
        return out
    return want


def phase_rev_zoo_paths(g, feats, layers, steps):
    """RevGCN with `GCNBlock` and with `SAGEBlock` at ``layers`` (80
    channels, group 2) on the proteins cluster: one warm-up, ``steps`` timed
    steps and a `predict` each, exact K1 launches, the peak, a profiled
    step."""
    infos = {}
    for conv in ("gcn", "sage"):
        tag = f"revgcn-{conv}-{layers}"
        infos[conv], step = phase_proteins_path(rev_zoo_app(conv), ["--num_layers", str(layers)],
                                                g, feats, steps, rev_k1_expected(2), tag)
        phase_profile(g.senders.device, step, tag=f"{tag}-profile")
        del step
        free_memory(g.senders.device)
    return infos


def phase_msgs_timing(g, errs, unfused, iters):
    """K2's message form in bf16 at phase 4's shape: the materialised
    messages relu(x_j) + ε of C=128 that the unfused ResGEN-28 gives it;
    `time_fn`'s and `device_ms`'s times, the plain version's and the bound
    (no single PyTorch call computes it). Returns its `kernels` row."""
    dev = g.senders.device
    n_pad, e, c = g.num_nodes_padded, g.n_edge, 128
    x = g.x.to(torch.bfloat16)
    m = (torch.relu(x.index_select(0, torch.clamp(g.senders.long(), max=n_pad - 1)))
         + torch.tensor(1e-7, dtype=torch.bfloat16)).contiguous()
    t = torch.tensor([0.1], device=dev)
    ms = time_fn(lambda: tsp.softmax_agg_msgs(m, g.row_ptr, t), dev, iters)
    d_ms = device_ms(lambda: tsp.softmax_agg_msgs(m, g.row_ptr, t), dev, iters)
    plain_ms = time_fn(lambda: tsp.softmax_agg_msgs_plain(m, g.row_ptr, t), dev, 3)
    # the real edges' messages read once, out (bf16) and lse (float32)
    # written once, row_ptr and t; per (edge, channel): the first walk's mul
    # and max, then mul, sub, exp, mul, 2 roundings, 2 adds
    b = bound(e * c * 2 + 4 * (n_pad + 1) + 4 + n_pad * c * 2 + n_pad * c * 4, 10 * e * c,
              e * c)
    log(f"[msgs-timing] K2 msgs C=128 bf16 (N_pad={n_pad} E={e}): {ms:.4f} ms, device "
        f"{d_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}), plain {plain_ms:.3f} ms; no single "
        f"PyTorch call computes it: library_ms is null; card: {CARD}")
    return {"name": "K2 softmax_agg_msgs", "route": "cuda",
            "source": f"{PKG}/csrc/softmax_agg.cu",
            "replaces": "deep_gcns_torch_tpu/ops/spmm_pallas.py:322",
            "launches": unfused["launches"]["K2 msgs"], "max_abs_err": errs["bf16"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
            "library_ms": None}


def phase_ppi_k1_timing(gp, ppi_infos, iters):
    """K1 at PPI's shapes: the edge cotangent [E_pad, C] of a PPI graph
    through the sender gather's backward (the gathered form over the CSC)
    and the receiver gather's (the plain CSR form), C=64 float32 (ResMRGCN-14
    x 64) and C=256 bf16 (ResMRGCN-28 x 256): `time_fn`'s and `device_ms`'s
    times, the plain version's, the bound and one PyTorch call beside it
    (`index_add_` by sender for the gathered form, `torch.segment_reduce`
    for the plain). Returns the `kernels` rows; each path's K1 launches are
    half gathered, half plain."""
    dev = gp.senders.device
    chk = Checks("ppi k1 timing")
    gen = torch.Generator(device=dev).manual_seed(22)
    rows = []
    n_pad, e, e_pad = gp.num_nodes_padded, gp.n_edge, gp.num_edges_padded
    for (c, dtype, tag), info in zip(((64, torch.float32, "C=64 f32"),
                                      (256, torch.bfloat16, "C=256 bf16")), ppi_infos):
        src = torch.randn(e_pad, c, device=dev, generator=gen).to(dtype)
        size = src.element_size()
        y = src if dev.type == "cuda" else src.float()  # the CPU's index_add_ in float32
        for form, ptr, idx in (("gather", gp.csc_col_ptr, gp.csc_perm),
                               ("plain", gp.row_ptr, None)):
            out = tsp.csr_seg_sum(src, ptr, idx)
            ms = time_fn(lambda: tsp.csr_seg_sum(src, ptr, idx), dev, iters)
            d_ms = device_ms(lambda: tsp.csr_seg_sum(src, ptr, idx), dev, iters)
            plain_ms = time_fn(lambda: tsp.csr_seg_sum_plain(src, ptr, idx), dev, 3)
            err = chk.close(f"K1 ppi {form} {tag}", out, tsp.csr_seg_sum_plain(src, ptr, idx),
                            **(TOL_F32 if dtype == torch.float32 else TOL_BF16))
            # the real edges' rows read once, out written once, the index
            # (gathered form) and the pointers; one add per (edge, channel)
            b = bound(e * c * size + n_pad * c * size + 4 * (n_pad + 1)
                      + (4 * e if idx is not None else 0), e * c)
            if idx is None:
                offsets = ptr.long()

                def lib():
                    return torch.segment_reduce(y[:e], "sum", offsets=offsets, axis=0)
            else:
                ids = gp.senders[:e].long()

                def lib():
                    return torch.zeros((n_pad, c), dtype=y.dtype, device=dev).index_add_(
                        0, ids, y[:e])
            lib_ms = time_fn(lib, dev, iters)
            chk.close(f"library yardstick vs K1 ppi {form} {tag}", lib(), out, **TOL_LIBRARY)
            rows.append({"name": f"K1 seg_sum_csr ppi {form} {tag}", "route": "cuda",
                         "source": f"{PKG}/csrc/seg_sum.cu",
                         "replaces": "deep_gcns_torch_tpu/ops/spmm_pallas.py:252",
                         "launches": info["launches"]["K1"] // 2, "max_abs_err": err,
                         "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
                         "library_ms": lib_ms})
            log(f"[ppi-k1-timing] K1 {form} {tag} (N_pad={n_pad} E={e}): {ms:.4f} ms, "
                f"device {d_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}), plain {plain_ms:.3f} "
                f"ms, {'torch.segment_reduce' if idx is None else 'index_add_'} "
                f"{lib_ms:.4f} ms; card: {CARD}")
        del src, y, out
    chk.raise_if_failed()
    return rows


# ---------------------------------------------------------------------------
# point clouds (phases 55-60)
# ---------------------------------------------------------------------------

# (B, N, k, C) of the two point-cloud training shapes: S3DIS blocks
# (sem_seg_dense's defaults) and ModelNet40 clouds (modelnet_cls's)
PC_S3DIS = (8, 4096, 16, 64)
PC_MODELNET = (32, 1024, 9, 64)
PC_TINY = (2, 256, 4, 32)   # --rehearse-cpu


def pc_knn_transpose(dev, shape, d, seed):
    """A dilated kNN (k, d) of uniform random xyz points at ``shape`` and its
    transpose; point 0 of cloud 0 is made no one's neighbour (its ids,
    its own included, moved to point 1), so its cotangent sum must be an
    exact 0."""
    b, n, k, _ = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(b, n, 3, device=dev, generator=gen)
    idx, _ = tknn.dilated_knn_graph_dense(x, k, d)
    idx[0][idx[0] == 0] = 1
    perm, _, ptr = tgather.neighbor_transpose(idx)
    deg = (ptr[1:] - ptr[:-1]).float()
    log(f"[pc] kNN transpose B={b} N={n} k={k} d={d}: E={idx.numel()}, in-degree mean "
        f"{float(deg.mean()):.2f} max {int(deg.max())} zero {int((deg == 0).sum())}")
    return idx, perm, ptr


def phase_pc_kernels(dev, shape):
    """(a) K1's gathered form on a real kNN transpose (d = 4) in f32 and
    bf16 against `csr_seg_sum_plain`, two launches bit for bit, the point
    with no in-edge exact 0; `gather_neighbors` forward (bit for bit) and
    backward (K1, launched once) against the plain index_select and its
    autograd scatter, and below 32 channels no launch."""
    chk = Checks("pc kernels")
    b, n, k, c = shape
    idx, perm, ptr = pc_knn_transpose(dev, shape, 4, 55)
    gen = torch.Generator(device=dev).manual_seed(56)
    e = idx.numel()
    for dtype, tag, tol in ((torch.float32, "f32", TOL_F32), (torch.bfloat16, "bf16", TOL_BF16)):
        g = torch.randn(e, c, device=dev, generator=gen).to(dtype)
        out = tsp.csr_seg_sum(g, ptr, perm)
        chk.close(f"K1 kNN transpose C={c} {tag}", out, tsp.csr_seg_sum_plain(g, ptr, perm),
                  **tol)
        chk.equal(f"K1 kNN transpose {tag} two launches bit for bit",
                  tsp.csr_seg_sum(g, ptr, perm), out)
        chk.equal(f"K1 kNN transpose {tag} point with no in-edge exact 0", out[0],
                  torch.zeros(c, dtype=dtype, device=dev))
    flat = (idx + (torch.arange(b, device=dev) * n)[:, None, None]).reshape(-1)
    for cc in (c, 9):
        x = torch.randn(b, n, cc, device=dev, generator=gen, requires_grad=True)
        co = torch.randn(b, n, k, cc, device=dev, generator=gen)
        reset_launches()
        out = tgather.gather_neighbors(x, idx)
        fwd = read_launches()["K1"]
        (out * co).sum().backward()
        launched = read_launches()["K1"]
        want_launches = (0, 1) if dev.type == "cuda" and cc >= 32 else (0, 0)
        xr = x.detach().clone().requires_grad_(True)
        ref = xr.reshape(b * n, cc).index_select(0, flat).reshape(b, n, k, cc)
        (ref * co).sum().backward()
        chk.equal(f"gather_neighbors C={cc} forward", out.detach(), ref.detach())
        chk.close(f"gather_neighbors C={cc} backward vs autograd's scatter", x.grad, xr.grad,
                  **TOL_F32)
        chk.equal(f"gather_neighbors C={cc} point with no in-edge exact 0", x.grad[0, 0],
                  torch.zeros(cc, device=dev))
        log(f"[pc kernels] gather_neighbors C={cc}: K1 launches forward {fwd}, backward "
            f"{launched - fwd} (want {want_launches})")
        if (fwd, launched - fwd) != want_launches:
            chk.failed.append(f"gather_neighbors C={cc} launches")
    sync(dev)
    chk.raise_if_failed()


def phase_pc_knn(dev, shape, iters):
    """(b) the exact dilated kNN on the card at d = 1, 4 and 27 against a
    float64 recomputation, tie-aware: each returned neighbour's distance
    within 1e-5 of the largest distance (the scale of the float32 matrix
    form's error) of the true rank r·d's, self at rank 0; the approximate
    form (d = 4) against its own rules: self first, no duplicate, the rest
    from the offset-0 subsample; and the kNN's time at each dilation (the
    largest topk is k·d of N)."""
    chk = Checks("pc knn")
    b, n, k, _ = shape
    x = torch.rand(b, n, 3, device=dev, generator=torch.Generator(device=dev).manual_seed(57))
    ar = torch.arange(n, device=dev)
    for d in (1, 4, 27):
        if k * d > n:
            continue
        nn_idx, _ = tknn.dilated_knn_graph_dense(x, k, d)
        worst = 0.0
        for i in range(b):
            x64 = x[i].double()
            dist = ((x64[:, None, :] - x64[None, :, :]) ** 2).sum(-1)
            want = torch.sort(dist, -1).values[:, : k * d: d]
            got = dist.gather(-1, nn_idx[i])
            worst = max(worst, float((got - want).abs().max()) / float(dist.max()))
            del dist
        ok = worst <= 1e-5 and bool((nn_idx[..., 0] == ar).all())
        log(f"[check] exact kNN k={k} d={d} vs float64: worst |d - d_true| / max d = "
            f"{worst:.3e} (limit 1e-5), self first {bool((nn_idx[..., 0] == ar).all())} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            chk.failed.append(f"exact kNN d={d}")
        ms = time_fn(lambda: tknn.dilated_knn_graph_dense(x, k, d), dev, iters)
        log(f"[pc knn] exact dilated kNN B={b} N={n} k={k} d={d} (topk {k * d} of {n}): "
            f"{ms:.3f} ms; card: {CARD}")
    d = 4
    ap, _ = tknn.dilated_knn_graph_dense(x, k, d, method="approx")
    srt = torch.sort(ap, -1).values
    ok = (bool((ap[..., 0] == ar).all()) and bool((srt[..., 1:] != srt[..., :-1]).all())
          and bool((ap[..., 1:] % d == 0).all()))
    log(f"[check] approx kNN k={k} d={d}: self first, no duplicate, ids from the subsample "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        chk.failed.append("approx kNN rules")
    ms = time_fn(lambda: tknn.dilated_knn_graph_dense(x, k, d, method="approx"), dev, iters)
    log(f"[pc knn] approx kNN d={d}: {ms:.3f} ms; card: {CARD}")
    chk.raise_if_failed()


def _pc_small_models(dev):
    """(kind, model builder, input) of the agreement models: 3 blocks, 32
    channels, k = 8, a few hundred points."""
    gen = torch.Generator().manual_seed(58)
    return [
        ("DenseDeepGCN", lambda: DenseDeepGCN(DeepGCNConfig(
            in_channels=9, n_classes=13, n_filters=32, n_blocks=3, conv="edge", k=8,
            dropout=0.0), torch.Generator().manual_seed(0)), torch.rand(2, 384, 9, generator=gen)),
        ("DeepGCNCls", lambda: DeepGCNCls(DeepGCNConfig(
            in_channels=3, n_classes=40, n_filters=32, n_blocks=3, conv="edge", k=8,
            dropout=0.0, emb_dims=128, stochastic=False), torch.Generator().manual_seed(0)),
         torch.rand(8, 256, 3, generator=gen)),
        ("SparseDeepGCN", lambda: SparseDeepGCN(DeepGCNConfig(
            in_channels=9, n_classes=13, n_filters=32, n_blocks=3, conv="edge", k=8,
            dropout=0.0, num_points=384), torch.Generator().manual_seed(0)),
         torch.rand(2 * 384, 9, generator=gen))]


def _named_flips(chk, tag, flips):
    """Logs each flip of the card's own kNN against the CPU's; one that is
    not a near tie (float64 gap above 1e-5 of the largest distance) fails."""
    for f in flips:
        near = f["rel_gap"] <= 1e-5
        log(f"[pc agreement] {tag}: kNN flip {f} ({'near tie' if near else 'NOT a near tie'})")
        if not near:
            chk.failed.append(f"{tag} kNN flip")


def phase_pc_agreement(dev):
    """(c) small DenseDeepGCN, DeepGCNCls and SparseDeepGCN on the card
    against the same weights on the CPU: the logits with the CPU's kNN
    graphs replayed on the card (`utils.agreement.KnnReplay`), then each
    graph layer on the CPU's input to it and the CPU's graph of it
    (`point_layer_results`): output, input gradient (K1 in the dense
    gathers' backward) and every parameter gradient. Where the card's own
    kNN differs from the CPU's, the flip is named; a flip that is not a near
    tie fails; the tolerances are phase 52's."""
    chk = Checks("pc agreement")
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(59)
    reset_launches()
    for name, build, x in _pc_small_models(dev):
        models = [build().to(d).train() for d in (dev, cpu)]
        sparse = name == "SparseDeepGCN"
        args = () if name == "DeepGCNCls" else (None,)
        with torch.no_grad():
            with KnnReplay() as rec:
                want = models[1](x, *args)
            with KnnReplay(rec.graphs) as rep:
                got = models[0](x.to(dev), *args)
        for i, flips in enumerate(rep.flips):
            _named_flips(chk, f"{name} logits kNN call {i}", flips)
        chk.close(f"{name} logits, card vs cpu (the CPU's graphs)", got.cpu(), want, 1e-4, 1e-4)
        for lname, outs, flips in point_layer_results(models, x, gen, sparse=sparse):
            tag = f"{name} {lname}"
            _named_flips(chk, tag, flips)
            chk.close(f"{tag} output", outs[0][0], outs[1][0], 1e-4, 1e-4)
            chk.close(f"{tag} input grad", outs[0][1], outs[1][1], 1e-3, 1e-4)
            g_max = max(float(v.abs().max()) for v in outs[1][2].values())
            for k in outs[1][2]:
                chk.close(f"{tag} grad {k}", outs[0][2][k], outs[1][2][k], 1e-3, 1e-4,
                          ref_max=g_max)
    launches = read_launches()
    log(f"[pc agreement] launches on the card {launches}")
    if dev.type == "cuda" and launches["K1"] == 0:
        raise AssertionError("pc agreement: K1 never launched")
    chk.raise_if_failed()


def pc_batch(app, args, dev, seed):
    """One batch of the app's synthetic data (S3DIS blocks or ModelNet
    clouds), on the card."""
    draw = (data_pointcloud.synthetic_modelnet if app is modelnet_cls
            else data_pointcloud.synthetic_s3dis)
    x, y = draw(np.random.default_rng(seed), args.batch_size, args.num_points, args.n_classes)
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def phase_pc_main(dev, tag, app, argv, steps, profile=True):
    """(d) ``app``'s `train_step` and `predict` (`apps/sem_seg_dense` or
    `apps/modelnet_cls`) at the app's defaults and ``argv``: one warm-up
    step, ``steps`` timed steps and a timed `predict`; K1 exactly
    n_blocks − 1 times in every backward (the head gathers 9 or 3 channels,
    below K1's gate) and never in a forward; finite losses, the peak, a
    profile of one more step."""
    args = app.get_args(["--device", dev.type] + argv)
    model = app.build_model(args, torch.Generator().manual_seed(0)).to(dev)
    opt, sched = app.make_optimizer(args, model, 6)
    x, y = pc_batch(app, args, dev, 60)
    gen = torch.Generator(device=dev).manual_seed(1)
    per_bwd = (args.n_blocks - 1) if dev.type == "cuda" and args.n_filters >= 32 else 0
    free_memory(dev)
    reset_launches()
    losses, times = [], []
    for i in range(steps + 1):
        t0 = time.perf_counter()
        loss = app.train_step(model, opt, x, y, gen)
        sched.step()
        sync(dev)
        if i:
            times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    after_steps = read_launches()
    t0 = time.perf_counter()
    pred = app.predict(model, x)
    sync(dev)
    predict_s = time.perf_counter() - t0
    if pred.shape != y.shape or int(pred.min()) < 0 or int(pred.max()) >= args.n_classes:
        raise AssertionError(f"{tag}: predict gave shape {tuple(pred.shape)}")
    launches = read_launches()
    want = no_launches()
    want["K1"] = per_bwd * (steps + 1)
    if after_steps != launches:
        raise AssertionError(f"{tag}: predict launched {launches} after {after_steps}")
    b, n = x.shape[:2]
    info = _path_info(tag, dev, losses, times, predict_s, launches, want,
                      {"points_per_s": b * n / (sorted(times)[len(times) // 2]),
                       "k1_per_backward": launches["K1"] // (steps + 1),
                       "n_blocks": args.n_blocks, "batch": [b, n]})
    if profile:
        phase_profile(dev, lambda: app.train_step(model, opt, x, y, gen), tag=f"{tag}-profile")
    del model, opt
    free_memory(dev)
    return info


def phase_pc_apps(dev, rehearse):
    """(e) each point-cloud app's `main` with `--synthetic --save_ckpt` for
    2 epochs, then its test or eval script on `ckpt_best`, whose score must
    equal the run's best (PartNet's eval on the validation shapes the run
    scored). Depths are cut to fit the time limit. Returns {app: (result,
    K1 launches)}."""
    small = (["--n_blocks", "3", "--n_filters", "32", "--num_points", "256", "--k", "4"]
             if rehearse else [])
    base = ["--synthetic", "--device", dev.type, "--epochs", "2"] + small
    depth = {} if rehearse else {"sem_seg_dense": ["--n_blocks", "14"],
                                 "sem_seg_sparse": ["--n_blocks", "7"],
                                 "modelnet_cls": [], "part_sem_seg": []}
    runs = {}
    for name, app, test_app, extra in (
            ("sem_seg_dense", sem_seg_dense, sem_seg_dense_test, []),
            ("sem_seg_sparse", sem_seg_sparse, sem_seg_sparse_test, []),
            ("modelnet_cls", modelnet_cls, None, ["--batch_size", "16"] if rehearse else []),
            ("part_sem_seg", part_sem_seg, part_sem_seg_eval, [])):
        argv = base + depth.get(name, []) + extra
        t0 = time.time()
        reset_launches()
        res = app.main(argv + ["--save_ckpt", "--exp_root", RUNS])
        k1 = read_launches()["K1"]
        t1 = time.time()
        ckpt = ["--pretrained_model", os.path.join(res["exp"], "ckpt_best")]
        if name == "modelnet_cls":
            scored = app.main(argv + ["--phase", "test"] + ckpt)["oa"]
        elif name == "part_sem_seg":
            scored = test_app.main(argv + ["--eval_phase", "val", "--res_dir",
                                           os.path.join(RUNS, "partseg")] + ckpt)["part_iou"]
        else:
            scored = test_app.main(argv + ckpt)["miou"]
        log(f"[pc-apps] {name} {' '.join(argv)}: losses {res['losses']} best {res['best']}, "
            f"scored {scored}; K1 launches {k1}; train {t1 - t0:.1f}s, score "
            f"{time.time() - t1:.1f}s; card: {CARD}")
        if scored != res["best"] or not all(map(math.isfinite, res["losses"])):
            raise AssertionError(f"pc-apps {name}: scored {scored}, the run's best {res['best']}")
        runs[name] = (res, k1)
        free_memory(dev)
    return runs


def phase_pc_k1_timing(dev, shapes, iters):
    """(f) K1's gathered form at the point-cloud shapes, as the gathers'
    backward calls it: the time (`time_fn`), the device time, the plain
    version's, the bound, `index_add_` of the [E, C] cotangent by the flat
    neighbour ids (autograd's scatter, which the K1 route replaces; the
    `library_ms`) and `torch.sparse.mm` of the transposed selection matrix.
    ``shapes``: (tag, shape, d, dtype, launches). Returns the rows."""
    chk = Checks("pc k1 timing")
    rows = []
    for tag, shape, d, dtype, launches in shapes:
        b, n, k, c = shape
        idx, perm, ptr = pc_knn_transpose(dev, shape, d, 61)
        e, rows_n = idx.numel(), b * n
        g = torch.randn(e, c, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(62)).to(dtype)
        size = g.element_size()
        out = tsp.csr_seg_sum(g, ptr, perm)
        err = chk.close(f"K1 {tag}", out, tsp.csr_seg_sum_plain(g, ptr, perm),
                        **(TOL_F32 if dtype == torch.float32 else TOL_BF16))
        ms = time_fn(lambda: tsp.csr_seg_sum(g, ptr, perm), dev, iters)
        d_ms = device_ms(lambda: tsp.csr_seg_sum(g, ptr, perm), dev, iters)
        plain_ms = time_fn(lambda: tsp.csr_seg_sum_plain(g, ptr, perm), dev, 3)
        # the cotangent read once, the permutation and pointers, the output
        # written once; one add per (edge, channel)
        bnd = bound(e * c * size + 4 * e + 4 * (rows_n + 1) + rows_n * c * size, e * c)
        flat = (idx + (torch.arange(b, device=dev) * n)[:, None, None]).reshape(-1)

        def lib():
            return torch.zeros((rows_n, c), dtype=dtype, device=dev).index_add_(0, flat, g)

        lib_ms = time_fn(lib, dev, iters)
        chk.close(f"index_add_ vs K1 {tag}", lib(), out, **TOL_LIBRARY)
        gs = g if dev.type == "cuda" else g.float()  # the CPU's sparse product in float32
        st = torch.sparse_coo_tensor(torch.stack([flat, torch.arange(e, device=dev)]),
                                     torch.ones(e, dtype=gs.dtype, device=dev), (rows_n, e),
                                     check_invariants=False).to_sparse_csr()
        sp_ms = time_fn(lambda: torch.sparse.mm(st, gs), dev, iters)
        chk.close(f"torch.sparse.mm vs K1 {tag}", torch.sparse.mm(st, gs), out, **TOL_LIBRARY)
        rows.append({"name": f"K1 seg_sum_csr pc {tag}", "route": "cuda",
                     "source": f"{PKG}/csrc/seg_sum.cu",
                     "replaces": "deep_gcns_torch_tpu/ops/spmm_pallas.py:252",
                     "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib_ms})
        log(f"[pc-k1-timing] K1 {tag} (E={e} rows={rows_n} C={c}): {ms:.4f} ms, device "
            f"{d_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}; {d_ms / bnd[0]:.2f}x), plain "
            f"{plain_ms:.3f} ms, index_add_ {lib_ms:.4f} ms, torch.sparse.mm {sp_ms:.4f} ms; "
            f"card: {CARD}")
        del g, out, st
        free_memory(dev)
    chk.raise_if_failed()
    return rows


def phase_pointcloud(dev, rehearse, iters):
    """Phases 55-60; returns the `kernels` rows of phase 60."""
    s3dis, modelnet = (PC_TINY, PC_TINY) if rehearse else (PC_S3DIS, PC_MODELNET)
    phase_pc_kernels(dev, s3dis)
    mark("pc kernels")
    phase_pc_knn(dev, s3dis, 2 if rehearse else 5)
    mark("pc knn")
    phase_pc_agreement(dev)
    mark("pc agreement")
    small = ["--n_blocks", "4", "--num_points", "256", "--k", "4"] if rehearse else []
    main_info = phase_pc_main(dev, "sem-seg-dense-resgcn28", sem_seg_dense, small,
                              2 if rehearse else 3)
    mark("pc main path")
    bf16_info = phase_pc_main(dev, "sem-seg-dense-resgcn28-bf16", sem_seg_dense,
                              small + ["--compute_dtype", "bfloat16"], 1, profile=False)
    mark("pc main path bf16")
    cls_info = phase_pc_main(dev, "modelnet-resgcn14", modelnet_cls,
                             small + (["--batch_size", "8", "--emb_dims", "64"]
                                      if rehearse else []), 2 if rehearse else 3)
    mark("pc modelnet path")
    runs = phase_pc_apps(dev, rehearse)
    shutil.rmtree(RUNS, ignore_errors=True)
    mark("pc apps")
    d_last = 4 if rehearse else 27
    c = s3dis[3]
    rows = phase_pc_k1_timing(dev, (
        (f"S3DIS d=1 C={c} f32", s3dis, 1, torch.float32, main_info["launches"]["K1"]),
        (f"S3DIS d={d_last} C={c} f32", s3dis, d_last, torch.float32,
         main_info["launches"]["K1"]),
        (f"S3DIS d=1 C={c} bf16", s3dis, 1, torch.bfloat16, bf16_info["launches"]["K1"]),
        (f"ModelNet d=1 C={modelnet[3]} f32", modelnet, 1, torch.float32,
         cls_info["launches"]["K1"])), iters)
    mark("pc k1 timing")
    return rows


# ---------------------------------------------------------------------------
# phases 61-66: the parallel layer (`--parallel`, with phases 67-70)
# ---------------------------------------------------------------------------

PAR_D = 2
# phase 62's eval forward of the spatial ResGEN-28 (bf16) against the
# single-process model: each route sums a layer's aggregate in another order
# (the halo split, the local band plus the halo partial, the message form's
# exact shift against the fused bound), so a layer's m may sit a few bf16
# ulps (2^-8 relative each) away, and 28 residual layers carry that to the
# logits
TOL_SPATIAL_BF16 = dict(rtol=2.0 ** -5, atol_rel=2.0 ** -5)
# float32 small models and steps, card against CPU or two orders of a sum
TOL_PAR_F32 = dict(rtol=1e-4, atol_rel=1e-4)
PAR_LAYERS_SMALL = 3


def _rank_globals():
    """A spawned rank runs this script's top level, not its main block:
    bind the modules that the shared helpers (`reset_launches`,
    `read_launches`, `sync`) read."""
    import numpy
    import torch as torch_
    from deep_gcns_torch_tpu_torch.ops import band, blocksparse, gat_dense, norm_act, spmm_cuda

    globals().update(np=numpy, torch=torch_, tsp=spmm_cuda, tband=band, tgd=gat_dense,
                     tbs=blocksparse, tna=norm_act)


def resgen_config(layers, n_tasks=40):
    """Phase 4's ResGEN (res+, softmax_sg t=0.1, batch norm, one-layer MLP,
    dropout 0.5, bf16, C=128)."""
    from deep_gcns_torch_tpu_torch.models import DeeperGCNConfig as Cfg

    return Cfg(in_channels=128, hidden_channels=128, num_tasks=n_tasks, num_layers=layers,
               block="res+", aggr="softmax_sg", t=0.1, norm="batch", mlp_layers=1,
               dropout=0.5, compute_dtype="bfloat16")


def spatial_expected(route, sh, layers, steps, cuda):
    """Kernel launches on one rank of ``steps`` spatial train steps and one
    eval forward of ResGEN (softmax_sg): the band route runs K3 on the local
    band both ways, K1 on the leftover wherever its (rank-unified) count is
    not 0 and K1 on the halo partial in each forward; the all-gather route
    runs K2's message form once a forward (its backward is PyTorch); the
    halo route's split aggregation sums den and num over the local and the
    halo part, four K1 a forward (the backward gathers)."""
    want = no_launches()
    if not cuda:
        return want
    fwd, bwd = layers * (steps + 1), layers * steps
    if route == "band":
        lo = int(sh.loc_band.fwd.n_lo > 0)
        want.update(K3=fwd + bwd, K1=fwd * (lo + 1) + bwd * lo)
    elif route == "allgather":
        want["K2 msgs"] = fwd
    else:
        want["K1"] = 4 * fwd
    return want


def _rank_resgen(rank, world, job):
    """Phase 62 on one rank: for each route the spatial ResGEN-28's eval
    logits at its first weights (rank 0 returns the gathered table), then a
    warm-up and ``steps`` timed train steps and an eval forward with the
    launch counts, collectives and bytes staged set to 0 just before and
    read just after."""
    _rank_globals()
    from deep_gcns_torch_tpu_torch.parallel import comm
    from deep_gcns_torch_tpu_torch.parallel.spatial import (SpatialDeeperGCN, masked_nll_sum,
                                                            rank_generator, spatial_forward,
                                                            spatial_train_step)
    from deep_gcns_torch_tpu_torch.utils.optim import make_optimizer

    dev = comm.rank_device(rank, job["device"])
    cuda = dev.type == "cuda"
    out = {}
    for route, graph, exchange in job["routes"]:
        shards, xs, labs = job["graphs"][graph]
        sh = shards.rank(rank, dev)
        x = torch.from_numpy(xs[rank]).to(dev)
        lab = torch.from_numpy(labs[rank]).to(dev)
        model = SpatialDeeperGCN(resgen_config(job["layers"]), exchange=exchange,
                                 generator=torch.Generator().manual_seed(0)).to(dev)
        opt = make_optimizer("adam", model.parameters(), 1e-2)
        gen = rank_generator(1, rank, dev)
        logits0 = spatial_forward(model, sh, x)
        sync(dev)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        comm.reset_stats()
        losses, times = [], []
        for i in range(job["steps"] + 1):
            t0 = time.perf_counter()
            loss = spatial_train_step(model, opt, sh, x, lab, sh.node_mask, masked_nll_sum,
                                      generator=gen)
            sync(dev)
            if i:
                times.append(time.perf_counter() - t0)
            losses.append(float(loss))
        t0 = time.perf_counter()
        logits = spatial_forward(model, sh, x)
        sync(dev)
        predict_s = time.perf_counter() - t0
        launches = read_launches()
        want = spatial_expected(route, sh, job["layers"], job["steps"] + 1, cuda)
        if launches != want:
            raise AssertionError(f"{route} rank {rank}: launches {launches} != {want}")
        if not all(math.isfinite(v) for v in losses) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{route} rank {rank}: losses {losses} or logits not finite")
        staged = comm.STATS["staged_bytes"]
        if exchange == "allgather" and cuda:
            # the all-gather's backward, a reduce-scatter, stages D·S·C in and
            # S·C out a layer a backward; an all-reduce of the whole cotangent
            # would stage D·S·C both ways (derived)
            bwd = job["layers"] * (job["steps"] + 1)
            extra = bwd * (world - 1) * sh.shard_size * 128 * 2
            log(f"[par-resgen] allgather rank {rank}: bytes staged {staged} with the "
                f"reduce-scatter backward; {staged + extra} with an all-reduce of the whole "
                f"cotangent (derived: + {bwd} backward calls x (D - 1)·S·C·2 bytes)")
        out[route] = {
            "losses": losses, "step_ms_all": [v * 1e3 for v in times],
            "step_ms_median": sorted(times)[len(times) // 2] * 1e3,
            "eval_forward_ms": predict_s * 1e3, "launches": launches,
            "halo_rows_per_layer": sh.total_halo if exchange != "allgather" else 0,
            "exchange": "halo" if exchange != "allgather" else "allgather",
            "collective_calls": comm.STATS["calls"],
            "bytes_staged": comm.STATS["staged_bytes"], "backend": torch.distributed.get_backend(),
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None,
            "logits0": logits0.float().cpu().numpy() if rank == 0 else None}
        del model, opt, logits0, logits
        if cuda:
            torch.cuda.empty_cache()
    return out


def par_graphs(n, dev, rehearse):
    """Phase 61: phase 7's power-law community graph in cluster order (its
    band, and each rank's local band) and phase 4's gather graph, each
    sharded over `PAR_D` ranks on the host (the gather graph also kept whole,
    for phase 67); the single-process ResGEN-28's eval logits of both on
    ``dev`` at seed 0's weights."""
    from deep_gcns_torch_tpu_torch.parallel import shard_graph, shard_nodes

    layers = PAR_LAYERS_SMALL if rehearse else 28
    graphs, single = {}, {}
    for name in ("band", "gather"):
        if name == "band":
            g, labels, _ = band_graph(n, torch.device("cpu"))
        else:
            g, labels = main_graph(n, torch.device("cpu"))
        s = g.senders[:g.n_edge].numpy()
        r = g.receivers[:g.n_edge].numpy()
        t0 = time.time()
        sh = shard_graph(s, r, g.n_node, PAR_D, band="auto" if name == "band" else "off")
        info = {"shard_s": time.time() - t0, "S": sh.shard_size,
                "halo_rows_per_rank_per_layer": sh.halo_rows_per_device,
                "off_pads": sh.off_pads,
                "auto_takes_halo": sh.halo_rows_per_device < (PAR_D - 1) * sh.shard_size,
                "valid_rows": sh.node_mask.sum(1).tolist()}
        if sh.loc_band is not None:
            info.update(window=sh.loc_band[0].fwd.window,
                        coverage=[b.fwd.coverage for b in sh.loc_band],
                        n_lo_unified=sh.loc_band[0].fwd.n_lo)
        log(f"[par-graphs] {name}: {json.dumps(info)}")
        x = g.x[:g.n_node].numpy()
        lab = np.asarray(labels)[:g.n_node].astype(np.int64)
        graphs[name] = (sh, shard_nodes(x, sh), shard_nodes(lab[:, None], sh)[..., 0])
        model = DeeperGCN(resgen_config(layers), generator=torch.Generator().manual_seed(0))
        model = model.to(dev).eval()
        with torch.no_grad():
            single[name] = model(g.x.to(dev), g.to(dev))[:g.n_node].float().cpu()
        if name == "gather":  # phase 67's whole graph (host), with its labels
            graphs["gather host"] = (g, lab)
        del model, g
        free_memory(dev)
    return graphs, single, layers


def _rank_tasks(rank, world, tasks):
    """Several phases' rank programs in one spawn: {name: fn(rank, world, job)}."""
    return {name: fn(rank, world, job) for name, fn, job in tasks}


def phase_par_resgen(dev, ranks, single, routes, layers):
    """Phase 62: the spatial ResGEN-28 on `PAR_D` ranks sharing the card
    (gloo, every collective staged through host memory; ``ranks`` from the
    spawn): the band graph with the halo exchange and the spatial × band
    route, the gather graph with the all-gather and with the halo split; the
    eval forward at seed 0's weights against the single-process model's."""
    chk = Checks("par-resgen")
    for route, graph, _ in routes:
        want = single[graph]
        got = torch.from_numpy(ranks[0][route].pop("logits0")[:want.shape[0]])
        chk.close(f"spatial ResGEN-{layers} {route} eval logits vs single process", got,
                  want, **TOL_SPATIAL_BF16)
        for r, rk in enumerate(ranks):
            rk[route].pop("logits0", None)
            where = (f"gloo, host-staged, {PAR_D} ranks sharing one card"
                     if dev.type == "cuda" else "gloo on the CPU")
            log(f"[par-resgen] {route} rank {r} ({where}): {json.dumps(rk[route])}; "
                f"card: {CARD}")
    chk.raise_if_failed()


def _small_models():
    """(name, kind, config, exchange) of phase 63's small models: a
    DeeperGCN with batch norm across ranks on the halo split, and a RevGCN
    GEN with edge features on the halo exchange, float32."""
    from deep_gcns_torch_tpu_torch.models import DeeperGCNConfig as DCfg, RevGCNConfig as RCfg

    return (("spatial DeeperGCN batch norm", "deeper", DCfg(
                in_channels=16, hidden_channels=32, num_tasks=12, num_layers=PAR_LAYERS_SMALL,
                block="res+", aggr="softmax", learn_t=True, norm="batch", mlp_layers=1,
                dropout=0.0), "halo"),
            ("spatial RevGCN gen edge features", "rev", RCfg(
                hidden_channels=32, num_tasks=12, num_layers=PAR_LAYERS_SMALL, group=2,
                aggr="softmax", dropout=0.0), "halo"))


def _rank_small(rank, world, job):
    """Phase 63 on one rank: one SGD step of each small model; the loss and
    the updated `state_dict`."""
    _rank_globals()
    from deep_gcns_torch_tpu_torch.parallel import comm
    from deep_gcns_torch_tpu_torch.parallel.spatial import (SpatialDeeperGCN, masked_bce_sum,
                                                            spatial_train_step)
    from deep_gcns_torch_tpu_torch.parallel.spatial_rev import SpatialRevGCN

    dev = comm.rank_device(rank, job["device"])
    sh = job["shards"].rank(rank, dev)
    t = {k: torch.from_numpy(v[rank]).to(dev) for k, v in job["data"].items()}
    out = {}
    for name, kind, cfg, exchange in _small_models():
        cls = SpatialDeeperGCN if kind == "deeper" else SpatialRevGCN
        model = cls(cfg, exchange=exchange, generator=torch.Generator().manual_seed(0)).to(dev)
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        x = t["x16"] if kind == "deeper" else t["species"]
        loss = spatial_train_step(model, opt, sh, x, t["labels"], t["mask"], masked_bce_sum,
                                  node_feats=None if kind == "deeper" else t["nf"])
        out[name] = (float(loss), {k: v.detach().float().cpu()
                                   for k, v in model.state_dict().items()})
    return out


def par_small_job(dev_type):
    """Phase 63's inputs: a 3,000-node graph with edge features sharded over
    `PAR_D` ranks, features, 12 binary tasks and a training mask."""
    from deep_gcns_torch_tpu_torch.parallel import shard_graph, shard_nodes

    rng = np.random.default_rng(4)
    n, e = 3000, 30000
    sh = shard_graph(rng.integers(0, n, e), rng.integers(0, n, e), n, PAR_D,
                     edge_attr=rng.random((e, 8)).astype(np.float32))
    data = {"x16": rng.standard_normal((n, 16)).astype(np.float32),
            "species": np.eye(8, dtype=np.float32)[rng.integers(0, 8, n)],
            "nf": rng.standard_normal((n, 8)).astype(np.float32),
            "labels": rng.integers(0, 2, (n, 12)).astype(np.float32),
            "mask": rng.random(n) < 0.7}
    data = {k: shard_nodes(v if v.ndim > 1 else v[:, None], sh) for k, v in data.items()}
    data["mask"] = data["mask"][..., 0] & sh.node_mask
    return dict(device=dev_type, shards=sh, data=data)


def phase_par_small(card, cpu):
    """Phase 63: the small models' spatial step on `PAR_D` card ranks
    (``card``, from phase 62's spawn) against `PAR_D` gloo ranks on the CPU
    (``cpu``, plain versions)."""
    chk = Checks("par-small")
    for name in cpu:
        (l_dev, s_dev), (l_cpu, s_cpu) = card[name], cpu[name]
        chk.close(f"{name} loss, card vs cpu ranks", torch.tensor([l_dev]),
                  torch.tensor([l_cpu]), **TOL_PAR_F32)
        ref_max = max(float(v.abs().max()) for v in s_cpu.values() if v.numel())
        for k in s_cpu:
            chk.close(f"{name} {k} after the step", s_dev[k], s_cpu[k], ref_max=ref_max,
                      **TOL_PAR_F32)
    chk.raise_if_failed()


def _rank_world_one(rank, world, job):
    """Phases 64 and 68's rank: the spatial ResGEN step (D=1) and the
    tensor-parallel one (T=1) in a world of one (NCCL on the card),
    deterministic algorithms on, each from seed 0's weights and generator
    ``rank_generator(1, 0)``."""
    _rank_globals()
    from deep_gcns_torch_tpu_torch.parallel import comm, make_grid
    from deep_gcns_torch_tpu_torch.parallel.spatial import (SpatialDeeperGCN, masked_nll_sum,
                                                            rank_generator, spatial_train_step)
    from deep_gcns_torch_tpu_torch.parallel.tensor import TPDeeperGCN, tp_train_step
    from deep_gcns_torch_tpu_torch.utils.loss import cross_entropy
    from deep_gcns_torch_tpu_torch.utils.optim import make_optimizer

    torch.use_deterministic_algorithms(True, warn_only=True)
    dev = comm.rank_device(rank, job["device"])
    sh = job["shards"].rank(0, dev)
    model = SpatialDeeperGCN(resgen_config(job["layers"]), exchange="auto",
                             generator=torch.Generator().manual_seed(0)).to(dev)
    opt = make_optimizer("adam", model.parameters(), 1e-2)
    gen = rank_generator(1, 0, dev)
    x, lab = torch.from_numpy(job["x"]).to(dev), torch.from_numpy(job["labels"]).to(dev)
    losses = [float(spatial_train_step(model, opt, sh, x, lab, sh.node_mask, masked_nll_sum,
                                       generator=gen)) for _ in range(2)]
    out = {"backend": torch.distributed.get_backend(), "losses": losses,
           "state": {k: v.detach().cpu() for k, v in model.state_dict().items()}}
    del model, opt
    grid = make_grid(1, 1)
    g = job["graph"].to(dev)
    lab_full = torch.from_numpy(job["tp_labels"]).to(dev)
    model = TPDeeperGCN(resgen_config(job["layers"]), grid.tp_group,
                        generator=torch.Generator().manual_seed(0)).to(dev)
    opt = make_optimizer("adam", model.parameters(), 1e-2)
    gen = rank_generator(1, 0, dev)
    out["tp_losses"] = [float(tp_train_step(model, opt, g, g.x, lab_full, g.node_mask,
                                            cross_entropy, generator=gen)) for _ in range(2)]
    out["tp_state"] = {k: v.detach().cpu() for k, v in model.single_state_dict().items()}
    return out


def phase_par_world_one(dev, rehearse):
    """Phases 64 and 68: D=1 (the all-gather route, K2's message form) and
    T=1 (the tensor-parallel model: the same gather and message form, its
    one-rank `psum_scatter`s and head sum) over NCCL, each against the
    single-process step on the same graph without its CSC (GENConv's unfused
    branch), two Adam steps, bit for bit."""
    from deep_gcns_torch_tpu_torch.parallel import launch, shard_graph, shard_nodes
    from deep_gcns_torch_tpu_torch.parallel.spatial import rank_generator

    n = 2000 if rehearse else 20000
    layers = PAR_LAYERS_SMALL if rehearse else 28
    rng = np.random.default_rng(6)
    s, r = add_self_loops(rng.integers(0, n, 14 * n), rng.integers(0, n, 14 * n), n)
    x = rng.standard_normal((n, 128)).astype(np.float32)
    labels = rng.integers(0, 40, n)
    sh = shard_graph(s, r, n, 1)
    g = build_graph(x, s, r, num_nodes=n, edge_pad=sh.senders.shape[1], with_csc=False)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        model = DeeperGCN(resgen_config(layers), generator=torch.Generator().manual_seed(0))
        model = model.to(dev)
        opt = make_optimizer("adam", model.parameters(), 1e-2)
        gen = rank_generator(1, 0, dev)
        gd = g.to(dev)
        lab_host = torch.zeros(gd.num_nodes_padded, dtype=torch.long)
        lab_host[:n] = torch.from_numpy(labels)
        lab = lab_host.to(dev)
        losses = [float(ogbn_arxiv.train_step(model, opt, gd, lab, gd.node_mask, gen))
                  for _ in range(2)]
        want = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    finally:
        torch.use_deterministic_algorithms(False)
    del model, opt, gd
    free_memory(dev)
    got = launch(_rank_world_one, 1, (dict(device=dev.type, layers=layers, shards=sh,
                                           x=shard_nodes(x, sh)[0], graph=g,
                                           tp_labels=lab_host.numpy(),
                                           labels=shard_nodes(labels[:, None], sh)[0, :, 0]),),
                 device=dev.type, deadline=600, threads=torch.get_num_threads())[0]
    chk = Checks("par-world-one")
    log(f"[par-world-one] backend {got['backend']}; losses spatial {got['losses']} single "
        f"{losses}")
    chk.equal("D=1 losses vs single process", torch.tensor(got["losses"]),
              torch.tensor(losses))
    for k in want:
        chk.equal(f"D=1 {k} after two steps", got["state"][k], want[k])
    if dev.type == "cuda" and got["backend"] != "nccl":
        chk.failed.append(f"backend {got['backend']} (expected nccl)")
    chk.raise_if_failed()
    return got, losses, want


def phase_tp_world_one(got, losses, want):
    """Phase 68 (run in phase 64's NCCL world of one): the tensor-parallel
    step at T=1 against the same single-process steps, bit for bit."""
    chk = Checks("tp-world-one")
    log(f"[tp-world-one] backend {got['backend']}; losses TP T=1 {got['tp_losses']} single "
        f"{losses}")
    chk.equal("T=1 losses vs single process", torch.tensor(got["tp_losses"]),
              torch.tensor(losses))
    if set(got["tp_state"]) != set(want):
        chk.failed.append(f"T=1 state names {sorted(set(got['tp_state']) ^ set(want))}")
    for k in want:
        if k in got["tp_state"]:
            chk.equal(f"T=1 {k} after two steps", got["tp_state"][k], want[k])
    chk.raise_if_failed()


def _dp_config():
    from deep_gcns_torch_tpu_torch.models import RevGCNConfig as RCfg

    return RCfg(hidden_channels=80, num_tasks=112, num_layers=PAR_LAYERS_SMALL, group=2,
                aggr="softmax", dropout=0.0)


def _rank_dp(rank, world, job):
    """Phase 65's rank: one cluster-DP SGD step on its cluster."""
    _rank_globals()
    from deep_gcns_torch_tpu_torch.models import RevGCN as Rev
    from deep_gcns_torch_tpu_torch.parallel import comm
    from deep_gcns_torch_tpu_torch.parallel.data_parallel import cluster_dp_train_step
    from deep_gcns_torch_tpu_torch.utils.loss import bce_with_logits

    dev = comm.rank_device(rank, job["device"])
    g, (sp, nf, lab) = job["clusters"][rank]
    g = g.to(dev)
    model = Rev(_dp_config(), generator=torch.Generator().manual_seed(0)).to(dev)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    t0 = time.perf_counter()
    loss = cluster_dp_train_step(model, opt, g, sp.to(dev), lab.to(dev), g.node_mask,
                                 bce_with_logits, node_feats=nf.to(dev))
    sync(dev)
    return {"loss": float(loss), "step_ms": (time.perf_counter() - t0) * 1e3,
            "state": {k: v.detach().cpu() for k, v in model.state_dict().items()}}


def par_dp_reference(dev, rehearse):
    """Phase 65's clusters (phase 13's shape, seeds 0 and 1, one a rank) and
    the sequential step on the mean of the two cluster losses on ``dev``:
    (clusters, loss, state after the step)."""
    from deep_gcns_torch_tpu_torch.utils.loss import bce_with_logits

    n, deg = (800, 10) if rehearse else (13_000, 60)
    clusters = []
    for seed in range(PAR_D):
        rng = np.random.default_rng(seed)
        g, _ = random_node_graph(rng, n, deg, 8, edge_dim=8)
        n_pad = g.num_nodes_padded
        sp = torch.zeros(n_pad, 8)
        sp[torch.arange(n), torch.from_numpy(rng.integers(0, 8, n))] = 1.0
        nf = torch.from_numpy(rng.standard_normal((n_pad, 8)).astype(np.float32))
        lab = torch.from_numpy(rng.integers(0, 2, (n_pad, 112)).astype(np.float32))
        clusters.append((g, (sp, nf, lab)))
    model = RevGCN(_dp_config(), generator=torch.Generator().manual_seed(0)).to(dev)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    model.train()
    loss = sum(bce_with_logits(model(sp.to(dev), g.to(dev), node_feats=nf.to(dev)),
                               lab.to(dev), g.node_mask.to(dev))
               for g, (sp, nf, lab) in clusters) / len(clusters)
    loss.backward()
    opt.step()
    want = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    loss = float(loss.detach())
    del model, opt
    free_memory(dev)
    return clusters, loss, want


def phase_par_dp(dev, ranks, want_loss, want):
    """Phase 65: cluster DP, a RevGCN in float32 on two proteins-shaped
    clusters, one a rank (``ranks``, from phase 62's spawn), against the
    sequential mean of the two cluster losses' step on the card."""
    chk = Checks("par-dp")
    ref_max = max(float(v.abs().max()) for v in want.values() if v.numel())
    where = "gloo, host-staged, ranks sharing one card" if dev.type == "cuda" else "CPU"
    for r, rk in enumerate(ranks):
        log(f"[par-dp] rank {r}: loss {rk['loss']} (sequential {want_loss}), step "
            f"{rk['step_ms']:.1f} ms ({where}); card: {CARD}")
        chk.close(f"rank {r} DP loss vs sequential mean", torch.tensor([rk["loss"]]),
                  torch.tensor([want_loss]), **TOL_PAR_F32)
        for k in want:
            chk.close(f"rank {r} {k}", rk["state"][k], want[k], ref_max=ref_max, **TOL_PAR_F32)
    chk.raise_if_failed()


def phase_par_apps(dev, rehearse, app_argv):
    """Phase 66: the apps with ``--spatial 2`` on `PAR_D` ranks sharing the
    card: ogbn-arxiv (ResGEN-28 bf16, 2 epochs, ``--save_ckpt``) at 80,000
    synthetic nodes (at 169,343 its all-gather route, which materialises the
    messages and takes the message form's eager backward, passes half the
    card a rank) and its test script on the checkpoint over the same ranks
    (the printed best validation accuracy exactly) and in one process
    (printed beside it); phase 18's RevGCN app (14 layers, one epoch);
    DyResGEN at 7 layers (phase 18's argv, learned t, cut from 112); and
    ogbn-products' ResGEN-14 for one epoch at 100,000 nodes (its
    2,449,029-node graph does not fit one card as a full-graph step)."""
    spatial = ["--spatial", str(PAR_D), "--device", dev.type]
    common = ["--synthetic", "--synthetic_nodes", "2000" if rehearse else "80000",
              "--num_layers", str(PAR_LAYERS_SMALL if rehearse else 28),
              "--compute_dtype", "bfloat16", "--device", dev.type]
    base = common + spatial
    t0 = time.time()
    run = ogbn_arxiv.main(base + ["--epochs", "2", "--save_ckpt", "--exp_root", RUNS])
    t1 = time.time()
    scored = ogbn_arxiv_test.main(base + ["--pretrained_model", run["ckpt"]])
    single = ogbn_arxiv_test.main(common + ["--pretrained_model", run["ckpt"]])
    log(f"[par-apps] arxiv: best valid {run['best_valid']}, losses {run['losses']}, "
        f"{t1 - t0:.1f}s; test script on {PAR_D} ranks {scored['accs']}, in one process "
        f"{single['accs']} (staged {run['staged_bytes']} bytes on rank 0; card: {CARD})")
    if scored["accs"]["valid"] != run["best_valid"]:
        raise AssertionError(f"par-apps: the test script scored valid "
                             f"{scored['accs']['valid']} != the run's {run['best_valid']}")
    for name, app, argv in (
            ("proteins-rev", ogbn_proteins_rev, app_argv),
            ("proteins-dyresgen", ogbn_proteins, app_argv + [
                "--learn_t", "--num_layers", "3" if rehearse else "7", "--synthetic_nodes",
                "3000" if rehearse else "40000"]),
            ("products", ogbn_products, ["--synthetic", "--synthetic_nodes",
                                         "2000" if rehearse else "100000", "--epochs", "1",
                                         "--num_layers", str(PAR_LAYERS_SMALL if rehearse
                                                             else 14)])):
        t0 = time.time()
        out = app.main(argv + spatial)
        log(f"[par-apps] {name}: best valid {out['best_valid']}, losses {out['losses']}, "
            f"{time.time() - t0:.1f}s host clock (data and partition included); card: {CARD}")
        if not all(math.isfinite(v) for v in out["losses"]) or not (
                0.0 <= out["best_valid"] <= 1.0):
            raise AssertionError(f"par-apps: {name} losses {out['losses']} best "
                                 f"{out['best_valid']}")


# ---------------------------------------------------------------------------
# phases 67-70: tensor parallelism (`--parallel`)
# ---------------------------------------------------------------------------

def tp_expected(layers, steps, cuda, csc):
    """Kernel launches on one rank of ``steps`` tensor-parallel ResGEN
    (softmax_sg) train steps and one eval forward: K2's message form once a
    layer a forward (the materialised messages of the channel slice), and,
    on a graph with its CSC, K1's gathered form once a layer a backward (the
    gather's backward); the spatial grid gathers its exchanged table with a
    plain index_select, so it runs no K1."""
    want = no_launches()
    if cuda:
        want["K2 msgs"] = layers * (steps + 1)
        if csc:
            want["K1"] = layers * steps
    return want


def tp_rev_expected(layers, group, steps, cuda):
    """Launches on one rank of ``steps`` `TPRevGCN` steps and one eval
    forward on a graph with its CSC: each group function runs K2's message
    form in the forward and again in the backward's fused inverse+VJP, whose
    gather backward is K1's gathered form; the eval forward runs it once."""
    want = no_launches()
    if cuda:
        lg = layers * group
        want.update({"K2 msgs": 2 * lg * steps + lg, "K1": lg * steps})
    return want


def _tp_run(tag, rank, dev, step, forward, want_fn, steps, extra=None):
    """The timed part of a TP phase on one rank: the counts and the
    collective statistics set to 0, a warm-up and ``steps`` timed steps,
    an eval forward, the launches against ``want_fn``; returns the info."""
    from deep_gcns_torch_tpu_torch.parallel import comm

    cuda = dev.type == "cuda"
    sync(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    comm.reset_stats()
    losses, times = [], []
    for i in range(steps + 1):
        t0 = time.perf_counter()
        loss = step()
        sync(dev)
        if i:
            times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    t0 = time.perf_counter()
    logits = forward()
    sync(dev)
    eval_s = time.perf_counter() - t0
    launches = read_launches()
    want = want_fn(steps + 1)
    if launches != want:
        raise AssertionError(f"{tag} rank {rank}: launches {launches} != {want}")
    if not all(math.isfinite(v) for v in losses) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{tag} rank {rank}: losses {losses} or logits not finite")
    info = {"losses": losses, "step_ms_all": [v * 1e3 for v in times],
            "step_ms_median": sorted(times)[len(times) // 2] * 1e3,
            "eval_forward_ms": eval_s * 1e3, "launches": launches,
            "collective_calls": comm.STATS["calls"], "bytes_staged": comm.STATS["staged_bytes"],
            "backend": torch.distributed.get_backend(),
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None}
    info.update(extra or {})
    return info


def _rank_tp_resgen(rank, world, job):
    """Phase 67 on one rank: `TPDeeperGCN` (phase 4's ResGEN-28, channels
    over the ``world`` ranks) on phase 4's whole gather graph: the eval
    logits at seed 0's weights (rank 0 returns them), then a warm-up, the
    timed steps and an eval forward."""
    _rank_globals()
    from deep_gcns_torch_tpu_torch.parallel import comm, make_grid
    from deep_gcns_torch_tpu_torch.parallel.spatial import rank_generator
    from deep_gcns_torch_tpu_torch.parallel.tensor import (TPDeeperGCN, tp_forward,
                                                           tp_train_step)
    from deep_gcns_torch_tpu_torch.utils.loss import cross_entropy
    from deep_gcns_torch_tpu_torch.utils.optim import make_optimizer

    dev = comm.rank_device(rank, job["device"])
    grid = make_grid(1, world)
    g_host, labels = job["graph"]
    g = g_host.to(dev)
    lab = torch.zeros(g.num_nodes_padded, dtype=torch.long)
    lab[:len(labels)] = torch.from_numpy(np.asarray(labels).reshape(-1))
    lab = lab.to(dev)
    model = TPDeeperGCN(resgen_config(job["layers"]), grid.tp_group,
                        generator=torch.Generator().manual_seed(0)).to(dev)
    opt = make_optimizer("adam", model.parameters(), 1e-2)
    gen = rank_generator(1, rank, dev)
    logits0 = tp_forward(model, g, g.x)[:g.n_node].float().cpu().numpy()
    info = _tp_run("tp-resgen", rank, dev,
                   lambda: tp_train_step(model, opt, g, g.x, lab, g.node_mask, cross_entropy,
                                         generator=gen),
                   lambda: tp_forward(model, g, g.x), lambda s: tp_expected(
                       job["layers"], s, dev.type == "cuda", True), job["steps"],
                   {"channels_a_rank": 128 // world})
    info["logits0"] = logits0 if rank == 0 else None
    del model, opt, g
    free_memory(dev)
    return info


def _rank_tp_rev(rank, world, job):
    """Phase 69 on one rank: `TPRevGCN` (RevGCN-L × 80, group 2, bf16, the
    proteins app's config) on phase 13's cluster: eval logits at seed 0's
    weights, then a warm-up, the timed steps and an eval forward; every tp
    rank draws the same dropout masks (one generator seed) and keeps its
    slices."""
    _rank_globals()
    from deep_gcns_torch_tpu_torch.parallel import comm, make_grid
    from deep_gcns_torch_tpu_torch.parallel.tensor_rev import (TPRevGCN, tp_rev_forward,
                                                               tp_rev_train_step)
    from deep_gcns_torch_tpu_torch.utils.loss import bce_with_logits
    from deep_gcns_torch_tpu_torch.utils.optim import make_optimizer

    dev = comm.rank_device(rank, job["device"])
    grid = make_grid(1, world)
    g = job["graph"].to(dev)
    sp, nf, lab = (t.to(dev) for t in job["feats"])
    cfg = job["cfg"]
    model = TPRevGCN(cfg, grid.tp_group, generator=torch.Generator().manual_seed(0)).to(dev)
    opt = make_optimizer("adam", model.parameters(), 1e-3)
    gen = torch.Generator(device=dev).manual_seed(1)
    logits0 = tp_rev_forward(model, g, sp, nf)[:g.n_node].float().cpu().numpy()
    info = _tp_run("tp-rev", rank, dev,
                   lambda: tp_rev_train_step(model, opt, g, sp, lab, g.node_mask,
                                             bce_with_logits, node_feats=nf, generator=gen),
                   lambda: tp_rev_forward(model, g, sp, nf), lambda s: tp_rev_expected(
                       cfg.num_layers, cfg.group, s, dev.type == "cuda"), job["steps"],
                   {"channels_a_group_a_rank": cfg.hidden_channels // cfg.group // world})
    info["logits0"] = logits0 if rank == 0 else None
    del model, opt, g
    free_memory(dev)
    return info


def _rank_spatial_tp(rank, world, job):
    """Phase 70 on one rank of the 2 × 2 grid: `SpatialTPDeeperGCN` on
    phase 7's cluster-ordered graph (its node shards as phase 62 cut them)
    with the halo exchange over gp: the gathered eval logits at seed 0's
    weights, then a warm-up, the timed steps and an eval forward."""
    _rank_globals()
    from deep_gcns_torch_tpu_torch.parallel import comm, make_grid
    from deep_gcns_torch_tpu_torch.parallel.spatial import masked_nll_sum, rank_generator
    from deep_gcns_torch_tpu_torch.parallel.spatial_tp import (SpatialTPDeeperGCN,
                                                               spatial_tp_forward,
                                                               spatial_tp_train_step)
    from deep_gcns_torch_tpu_torch.utils.optim import make_optimizer

    dev = comm.rank_device(rank, job["device"])
    grid = make_grid(*job["grid"])
    shards, xs, labs = job["graph"]
    sh = shards.rank(grid.gp_index, dev)
    x = torch.from_numpy(xs[grid.gp_index]).to(dev)
    lab = torch.from_numpy(labs[grid.gp_index]).to(dev)
    model = SpatialTPDeeperGCN(resgen_config(job["layers"]), grid, exchange="halo",
                               generator=torch.Generator().manual_seed(0)).to(dev)
    opt = make_optimizer("adam", model.parameters(), 1e-2)
    gen = rank_generator(1, rank, dev)
    logits0 = spatial_tp_forward(model, sh, x).float().cpu().numpy()
    info = _tp_run("spatial-tp", rank, dev,
                   lambda: spatial_tp_train_step(model, opt, sh, x, lab, sh.node_mask,
                                                 masked_nll_sum, generator=gen),
                   lambda: spatial_tp_forward(model, sh, x), lambda s: tp_expected(
                       job["layers"], s, dev.type == "cuda", False), job["steps"],
                   {"grid": [grid.gp_index, grid.tp_index],
                    "halo_rows_per_layer": sh.total_halo,
                    "halo_row_channels": 128 // grid.tp_size})
    info["logits0"] = logits0 if rank == 0 else None
    del model, opt
    free_memory(dev)
    return info


def _tp_report(chk, tag, dev, ranks, want, what):
    """The eval logits at seed 0's weights (rank 0's) against the
    single-process model's within TOL_SPATIAL_BF16, and each rank's figures
    printed as what they are."""
    got = torch.from_numpy(ranks[0].pop("logits0")[:want.shape[0]])
    chk.close(f"{what} eval logits vs single process", got, want, **TOL_SPATIAL_BF16)
    where = (f"gloo, host-staged, {len(ranks)} ranks sharing one card"
             if dev.type == "cuda" else "gloo on the CPU")
    for r, rk in enumerate(ranks):
        rk.pop("logits0", None)
        log(f"[{tag}] rank {r} ({where}): {json.dumps(rk)}; card: {CARD}")


def tp_rev_reference(dev, rehearse, layers):
    """Phase 69's inputs: phase 13's cluster (host) with its features, the
    proteins RevGCN app's config at ``layers`` in bf16, and the
    single-process RevGCN's eval logits at seed 0's weights on ``dev`` on
    the cluster without its CSC (GENConv's unfused branch: the gather and
    message form the tensor-parallel group functions run)."""
    g, feats = cluster_graph(*((800, 10) if rehearse else (13_000, 60)), torch.device("cpu"))
    args = ogbn_proteins_rev.get_args(["--num_layers", str(layers), "--compute_dtype",
                                       "bfloat16", "--device", dev.type])
    model = ogbn_proteins_rev.build_model(args, torch.Generator().manual_seed(0)).to(dev)
    model.eval()
    sp, nf, _ = (t.to(dev) for t in feats)
    with torch.no_grad():
        want = model(sp, without_csc(g).to(dev), node_feats=nf)[:g.n_node].float().cpu()
    cfg = model.cfg
    del model
    free_memory(dev)
    return g, feats, cfg, want


def phase_tp_apps(dev, rehearse):
    """Phase 70's apps: ogbn-arxiv (ResGEN-28 bf16, 2 epochs, ``--save_ckpt``)
    with ``--tp 2`` and with ``--spatial 2 --tp 2`` at phase 66's 80,000
    synthetic nodes, each scored by its test script in one process, which
    must give the run's printed best validation accuracy exactly."""
    common = ["--synthetic", "--synthetic_nodes", "2000" if rehearse else "80000",
              "--num_layers", str(PAR_LAYERS_SMALL if rehearse else 28),
              "--compute_dtype", "bfloat16", "--device", dev.type]
    for grid in (["--tp", "2"], ["--spatial", "2", "--tp", "2"]):
        t0 = time.time()
        run = ogbn_arxiv.main(common + grid + ["--epochs", "2", "--save_ckpt",
                                               "--exp_root", RUNS])
        t1 = time.time()
        single = ogbn_arxiv_test.main(common + ["--pretrained_model", run["ckpt"]])
        log(f"[tp-apps] arxiv {' '.join(grid)}: best valid {run['best_valid']}, losses "
            f"{run['losses']}, {t1 - t0:.1f}s host clock (data included); collective calls "
            f"{run['collective_calls']}, staged {run['staged_bytes']} bytes on rank 0; the "
            f"test script in one process {single['accs']} (card: {CARD})")
        if not all(math.isfinite(v) for v in run["losses"]):
            raise AssertionError(f"tp-apps: {grid} losses {run['losses']}")
        if single["accs"]["valid"] != run["best_valid"]:
            raise AssertionError(f"tp-apps: {grid}: the test script scored valid "
                                 f"{single['accs']['valid']} != the run's {run['best_valid']}")


def phase_parallel(dev, rehearse):
    """Phases 61-70 (after the parent freed its own models): the card's two
    ranks run phases 62, 63, 65, 67 and 69 in one spawn, the CPU's ranks
    phase 63's other side; phases 64 and 68 share one NCCL world of one, and
    phase 70's grid is one spawn of four (its apps spawn their own)."""
    from deep_gcns_torch_tpu_torch.parallel import launch

    free_memory(dev)
    n = 2000 if rehearse else 169_343
    graphs, single, layers = par_graphs(n, dev, rehearse)
    clusters, dp_loss, dp_want = par_dp_reference(dev, rehearse)
    rev_layers = 3 if rehearse else 101
    g_rev, feats_rev, cfg_rev, want_rev = tp_rev_reference(dev, rehearse, rev_layers)
    gather_host = graphs.pop("gather host")
    mark("parallel graphs and references")
    routes = [("band", "band", "auto"), ("allgather", "gather", "allgather"),
              ("halo", "gather", "halo")]
    t0 = time.time()
    card = launch(_rank_tasks, PAR_D, ([
        ("resgen", _rank_resgen, dict(device=dev.type, layers=layers, steps=1, routes=routes,
                                      graphs=graphs)),
        ("small", _rank_small, par_small_job(dev.type)),
        ("dp", _rank_dp, dict(device=dev.type, clusters=clusters)),
        ("tp", _rank_tp_resgen, dict(device=dev.type, layers=layers, steps=1,
                                     graph=gather_host)),
        ("tp_rev", _rank_tp_rev, dict(device=dev.type, steps=1, graph=g_rev, feats=feats_rev,
                                      cfg=cfg_rev))],), device=dev.type, deadline=1200)
    log(f"[parallel] the card's ranks: {time.time() - t0:.1f}s (spawn included)")
    del clusters, g_rev, feats_rev, gather_host
    phase_par_resgen(dev, [rk["resgen"] for rk in card], single, routes, layers)
    mark("parallel resgen")
    cpu = launch(_rank_small, PAR_D, (par_small_job("cpu"),), device="cpu", deadline=300)
    phase_par_small(card[0]["small"], cpu[0])
    mark("parallel small models")
    phase_par_dp(dev, [rk["dp"] for rk in card], dp_loss, dp_want)
    mark("parallel cluster dp")
    world_one = phase_par_world_one(dev, rehearse)
    mark("parallel world of one")
    app_argv = ["--synthetic", "--synthetic_nodes", "3000" if rehearse else "132534",
                "--synthetic_degree", "8" if rehearse else "60", "--eval_every", "1",
                "--num_layers", "3" if rehearse else "14", "--compute_dtype", "bfloat16",
                "--epochs", "1"]
    phase_par_apps(dev, rehearse, app_argv)
    shutil.rmtree(RUNS, ignore_errors=True)
    mark("parallel apps")
    chk = Checks("tp-resgen")
    _tp_report(chk, "tp-resgen", dev, [rk["tp"] for rk in card], single["gather"],
               f"TP ResGEN-{layers} T={PAR_D}")
    chk.raise_if_failed()
    mark("tp resgen")
    phase_tp_world_one(*world_one)
    mark("tp world of one")
    chk = Checks("tp-rev")
    _tp_report(chk, "tp-rev", dev, [rk["tp_rev"] for rk in card], want_rev,
               f"TPRevGCN-{rev_layers} T={PAR_D}")
    chk.raise_if_failed()
    mark("tp revgcn")
    t0 = time.time()
    grid_ranks = launch(_rank_spatial_tp, 2 * PAR_D, (dict(
        device=dev.type, layers=layers, steps=1, grid=(PAR_D, 2), graph=graphs["band"]),),
        device=dev.type, deadline=900)
    log(f"[parallel] the grid's ranks: {time.time() - t0:.1f}s (spawn included)")
    chk = Checks("spatial-tp")
    _tp_report(chk, "spatial-tp", dev, grid_ranks, single["band"],
               f"spatial x TP ResGEN-{layers} {PAR_D}x2")
    chk.raise_if_failed()
    del graphs
    mark("spatial x tp")
    phase_tp_apps(dev, rehearse)
    shutil.rmtree(RUNS, ignore_errors=True)
    mark("tp apps")


def main(argv):
    rehearse = "--rehearse-cpu" in argv
    if not rehearse and not torch.cuda.is_available():
        log("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
        return 1
    dev = torch.device("cpu" if rehearse else "cuda")
    n, layers, steps, iters = (2000, 3, 2, 2) if rehearse else (169_343, 28, 3, 50)
    t_all = time.time()
    info = phase_device(dev)
    mark("device")
    if "--kernel-times" in argv:
        phase_kernel_times(dev, n, (800, 10) if rehearse else (13_000, 60), iters,
                           "--output-hashes" in argv)
        return 0
    if "--ogb" in argv:
        rows = phase_ogb(dev, rehearse, iters)
        shutil.rmtree(RUNS, ignore_errors=True)
        print(json.dumps({"kernels": rows}))
        return 0
    if "--pointcloud" in argv:
        rows = phase_pointcloud(dev, rehearse, iters)
        shutil.rmtree(RUNS, ignore_errors=True)
        print(json.dumps({"kernels": rows}))
        return 0
    if "--parallel" in argv:
        phase_parallel(dev, rehearse)
        return 0
    if "--norm-act" in argv:
        print(json.dumps({"kernels": phase_norm_act(dev, rehearse, iters)}))
        return 0
    forms = kernel_forms_arg(argv)
    if forms:
        if rehearse:
            log("--kernel-forms builds CUDA sources: it runs on the card only")
            return 1
        phase_kernel_forms(dev, n, iters, forms)
        return 0
    g, labels = main_graph(n, dev)
    g_main, labels_main = g, labels  # the remat phase runs on it at the end
    errs = phase_kernels(g)
    mark("kernels")
    phase_agreement(dev)
    mark("agreement")
    main_info, state = phase_main_path(g, labels, layers, steps)
    mark("main path")
    phase_profile(dev, arxiv_step(g, state))
    del state
    rows = phase_timing(g, errs, main_info["launches"], iters)
    del g
    log(f"[done] gather-route phases in {time.time() - t_all:.1f}s")

    gb, labels_b, _ = band_graph(n, dev)
    mark("band graph")
    errs_b = phase_band_kernels(gb)
    mark("band kernels")
    band_info, state = phase_main_path(gb, labels_b, layers, steps, tag="band-main")
    phase_profile(dev, arxiv_step(gb, state), tag="band-profile")
    del state
    gather_info, _ = phase_main_path(gb.replace(band=None), labels_b, layers, 1,
                                     tag="band-graph-gather")
    log(f"[band-main] band/gather step ratio on the same graph: "
        f"{band_info['step_ms_median'] / gather_info['step_ms_median']:.4f} "
        f"({band_info['step_ms_median']:.3f} / {gather_info['step_ms_median']:.3f} ms)")
    k3_row = phase_band_timing(gb, errs_b, band_info["launches"], iters)
    free = phase_zoo_band(gb, dev, 2000 if rehearse else 100_000)
    phase_extreme_timing(free, dev, rehearse, min(iters, 10))
    del free
    mark("zoo band routes")
    k1_lo = {"band": (gb.band.fwd.lo_row_ptr, gb.band.fwd.lo_src)}  # phase 39's leftover
    del gb
    log(f"[done] band-route phases in {time.time() - t_all:.1f}s")

    gpr, feats = cluster_graph(*((800, 10) if rehearse else (13_000, 60)), dev)
    errs_e = phase_edge_kernels(gpr)
    mark("edge kernels")
    phase_edge_agreement(dev)
    mark("edge agreement")
    rev = phase_rev_paths(gpr, feats, (3, 5) if rehearse else (101, 1001), (1, 1))
    dy_layers = 3 if rehearse else 112
    phase_proteins_path(ogbn_proteins, ["--learn_t", "--num_layers", str(dy_layers),
                                        "--compute_dtype", "bfloat16"],
                        gpr, feats, 1, dyresgen_expected, f"dyresgen-{dy_layers}")
    app_argv = ["--synthetic", "--synthetic_nodes", "3000" if rehearse else "132534",
                "--synthetic_degree", "8" if rehearse else "60", "--cluster_number", "10",
                "--num_layers", "3" if rehearse else "14", "--eval_parts", "5",
                "--compute_dtype", "bfloat16", "--epochs", "1"]
    mark("rev and dyresgen paths")
    phase_proteins_app(dev, app_argv)
    mark("proteins app")
    phase_rev_zoo_paths(gpr, feats, 3 if rehearse else 101, 2)
    mark("revgcn gcn and sage")
    edge_rows = phase_edge_timing(gpr, errs_e, max(rev.values(),
                                                   key=lambda i: i["layers"])["launches"],
                                  iters)
    rows = rows[:3] + edge_rows[:1] + [k3_row] + edge_rows[1:]
    del gpr, feats
    log(f"[done] proteins phases in {time.time() - t_all:.1f}s")

    ggat, labels_g = revgat_graph(n, dev)
    mark("revgat graph")
    errs_g = phase_gat_kernels(ggat)
    mark("gat kernels")
    phase_gat_agreement(dev)
    mark("gat agreement")
    gat_steps = 2
    band_info, step = phase_revgat_path(ggat, labels_g, gat_steps, "revgat-band")
    phase_profile(dev, step, tag="revgat-band-profile")
    del step
    csc_info, step = phase_revgat_path(ggat.replace(band=None), labels_g, gat_steps,
                                       "revgat-csc")
    phase_profile(dev, step, tag="revgat-csc-profile")
    del step
    free_memory(dev)
    log(f"[revgat] csc/band step ratio on the same graph: "
        f"{csc_info['step_ms_median'] / band_info['step_ms_median']:.4f} "
        f"({csc_info['step_ms_median']:.3f} / {band_info['step_ms_median']:.3f} ms)")
    mark("revgat paths")
    phase_revgat_app(dev, ["--synthetic", "--synthetic_nodes", "1000" if rehearse else "20000",
                           "--epochs", "2" if rehearse else "6", "--compute_dtype", "bfloat16"])
    rows += phase_gat_timing(ggat, errs_g, csc_info["launches"], iters)
    log(f"[done] sender-score GAT phases in {time.time() - t_all:.1f}s")
    rows += phase_norm_act(dev, rehearse, iters)
    mark("norm-act")

    errs_d = phase_dense_kernels(ggat)
    mark("dense kernels")
    phase_dense_agreement(dev)
    mark("dense agreement")
    dense_info, step = phase_revgat_path(ggat, labels_g, 2 if rehearse else 3, "revgat-dense",
                                         ["--use_attn_dst"])
    phase_profile(dev, step, tag="revgat-dense-profile")
    del step
    free_memory(dev)
    pr_info, _ = phase_revgat_path(ggat, labels_g, 1, "revgat-per-receiver",
                                   ["--gat_stabilizer", "per_receiver"], with_predict=False)
    free_memory(dev)
    log(f"[revgat] dense/band (destination scores against the sender-only auto band "
        f"step): {dense_info['step_ms_median'] / band_info['step_ms_median']:.4f}; "
        f"per_receiver/auto on the band: "
        f"{pr_info['step_ms_median'] / band_info['step_ms_median']:.4f} "
        f"({pr_info['step_ms_median']:.3f} / {band_info['step_ms_median']:.3f} ms; the JAX "
        f"package measured 1.82 on a TPU v5e, information only)")
    mark("dense paths")
    rows += phase_dense_timing(ggat, errs_d, dense_info["launches"], iters)
    k1_lo["gat"] = (ggat.band.fwd.lo_row_ptr, ggat.band.fwd.n_lo)
    del ggat
    free_memory(dev)
    log(f"[done] dense-route phases in {time.time() - t_all:.1f}s")

    bg = bsp_graph(n, dev)
    errs_10 = phase_bsp_kernels(bg, dev)
    mark("bsp kernels")
    rows.append(phase_bsp_timing(bg, errs_10, iters))
    del bg
    mark("bsp timing")
    shutil.rmtree(RUNS, ignore_errors=True)
    phase_ckpt_arxiv(dev, rehearse)
    mark("checkpoint path, arxiv")
    phase_ckpt_revgat(dev, rehearse)
    mark("checkpoint path, revgat")
    phase_ckpt_proteins(dev, rehearse)
    shutil.rmtree(RUNS, ignore_errors=True)
    mark("checkpoint path, proteins")
    free_memory(dev)
    phase_remat(g_main, labels_main, layers)
    mark("remat")
    free_memory(dev)
    phase_mean_route(g_main, labels_main, layers, 2)
    mark("mean route")
    phase_k1_corners(dev)
    mark("k1 corners")
    phase_k1_timing(g_main, k1_lo, iters)
    mark("k1 timing")
    errs_m = phase_msgs_kernels(g_main, k2_corner_graph(dev))
    mark("msgs kernels")
    phase_agreement(dev, csc=False)
    mark("unfused agreement")
    unfused = phase_unfused_path(g_main, labels_main, layers, main_info)
    mark("unfused path")
    rows.append(phase_msgs_timing(g_main, errs_m, unfused, iters))
    del g_main
    free_memory(dev)
    ppi_infos, small = [], ["--n_blocks", "3", "--n_filters", "32"] if rehearse else []
    for tag, argv in (("ppi-resmrgcn-14x64", []),
                      ("ppi-resmrgcn-28x256-bf16", ["--n_blocks", "28", "--n_filters", "256",
                                                    "--compute_dtype", "bfloat16"])):
        ppi_info, g_ppi = phase_ppi_path(dev, tag, argv + small, 3, rehearse)
        ppi_infos.append(ppi_info)
        mark(tag)
    rows += phase_ppi_k1_timing(g_ppi, ppi_infos, iters)
    del g_ppi
    mark("ppi k1 timing")
    phase_ppi_app(dev, rehearse)
    mark("ppi app")
    phase_zoo_agreement(dev)
    mark("zoo agreement")
    free_memory(dev)
    rows += phase_ogb(dev, rehearse, iters)
    shutil.rmtree(RUNS, ignore_errors=True)
    free_memory(dev)
    rows += phase_pointcloud(dev, rehearse, iters)
    shutil.rmtree(RUNS, ignore_errors=True)
    phase_parallel(dev, rehearse)
    log(f"[done] all phases in {time.time() - t_all:.1f}s")
    if rehearse:
        print(json.dumps({"kernels": rows}))
        print(json.dumps({"ok": True, "rehearsal": "cpu"}))
        return 0
    print(info["smi"])
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if not os.path.isdir(os.path.join(ROOT, PKG, "csrc")):
        print(f"{PKG}/ not found beside chip_smoke.py: run it from a checkout of the "
              "repository", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from deep_gcns_torch_tpu_torch import native
    from types import SimpleNamespace

    from deep_gcns_torch_tpu_torch.apps import (modelnet_cls, ogbg_mol, ogbg_mol_test, ogbg_ppa,
                                                ogbg_ppa_test, ogbl_collab, ogbl_collab_test,
                                                ogbn_arxiv, ogbn_arxiv_dgl, ogbn_arxiv_test,
                                                ogbn_products, ogbn_products_test,
                                                ogbn_proteins, ogbn_proteins_rev,
                                                ogbn_proteins_test, part_sem_seg,
                                                part_sem_seg_eval, ppi, ppi_test, sem_seg_dense,
                                                sem_seg_dense_test, sem_seg_sparse,
                                                sem_seg_sparse_test)
    from deep_gcns_torch_tpu_torch.convs.sparse import GATConv, GENConv, graph_conv
    from deep_gcns_torch_tpu_torch.data.ogb_features import (ATOM_FEATURE_DIMS,
                                                             BOND_FEATURE_DIMS)
    from deep_gcns_torch_tpu_torch.data.partition import random_partition_graph
    from deep_gcns_torch_tpu_torch.data.reorder import cluster_order, permute_graph
    from deep_gcns_torch_tpu_torch.data.synthetic import (powerlaw_community_edges,
                                                          random_node_graph)
    from deep_gcns_torch_tpu_torch.graph import (add_self_loops, attach_band, build_graph,
                                                 longest_first, to_undirected)
    from deep_gcns_torch_tpu_torch.data import pointcloud as data_pointcloud
    from deep_gcns_torch_tpu_torch.models import (DeepGCNCls, DeepGCNConfig, DeepGCNStatic,
                                                  DeeperGCN, DeeperGCNConfig, DenseDeepGCN,
                                                  RevGAT, RevGATConfig, RevGCN, RevGCNConfig,
                                                  SparseDeepGCN)
    from deep_gcns_torch_tpu_torch.nn.core import BatchNorm, Linear
    from deep_gcns_torch_tpu_torch.ops import _build
    from deep_gcns_torch_tpu_torch.ops import band as tband
    from deep_gcns_torch_tpu_torch.ops import blocksparse as tbs
    from deep_gcns_torch_tpu_torch.ops import gat_dense as tgd
    from deep_gcns_torch_tpu_torch.ops import gather as tgather
    from deep_gcns_torch_tpu_torch.ops import knn as tknn
    from deep_gcns_torch_tpu_torch.ops import norm_act as tna
    from deep_gcns_torch_tpu_torch.ops.gather import gather_src_auto
    from deep_gcns_torch_tpu_torch.ops import segment as tseg
    from deep_gcns_torch_tpu_torch.ops import spmm_cuda as tsp
    from deep_gcns_torch_tpu_torch.utils.agreement import (KnnReplay, layer_results,
                                                           point_layer_results)
    from deep_gcns_torch_tpu_torch.utils.optim import linear_schedule, make_optimizer

    sys.exit(main(sys.argv[1:]))
