"""Drive the PyTorch port on one CUDA card and hold its kernels to their plain versions.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: the card's name and power limit, TF32 flags, and the build of
   every CUDA kernel from facodec_tpu_torch/csrc (nvcc, timed).
2. Kernels against their plain PyTorch versions on the card, at the shapes
   of the flagship codec's main path, batch 4 x 10 s: the fused residual
   unit on the very inputs each of its 24 units receives in one reconstruct
   (captured with forward pre-hooks), and the VQ search on the 6 latents its
   quantizers give it in one encode (forward hooks on each in_proj, M =
   4 * 800 rows against a 1024 x 8 codebook), plus random latents and a
   codebook with duplicated rows. Times are medians of CUDA-event timings;
   the VQ search's device time per call is that of 200 calls replayed in
   one CUDA graph, its wrapper time that of one call. For each residual-unit
   shape: FLOP, the bound on float32 CUDA cores and on the kernel's 3xTF32
   tensor cores, TFLOP/s reached, and the error of kernel and plain version
   against a float64 evaluation of the plain version.
3. The slice at full width: the flagship FACodec with seeded random weights
   encodes, decodes and reconstructs the same batch of 4 x 10 s waves; the
   kernels' launch counts show that the path went through them. The JSON's
   `launches` are those of the encode -> decode round trip.
4. The card against the CPU: the same weights at batch 1 x 2 s through the
   port on the CPU (plain versions) and on the card (kernels).
5. Zero-shot voice conversion at full width: `convert_voice` with the
   phase-3 codec's modules at n_c = 1 and the published redecoder
   (`FLAGSHIP_REDECODER`, seeded random weights: embed 512, WN 16, decoder
   1536, non-causal, LSTM 2), source and target batches of 4 x 10 s. The
   launch counts show that it ran 36 residual units (12 encoder units on the
   source, 12 on the target, 12 non-causal decoder units) and 10 VQ searches.
   5a holds the residual-unit kernel to its plain version on the inputs of
   the 12 non-causal decoder units of one resynthesis, as phase 2a does.
6. Voice conversion card against CPU: the same source codes and target
   timbre through a CPU redecoder and a card redecoder of one seed, batch
   1 x 2 s. 6a: a `.fac` file on the card: encode -> bytes -> decode equals
   the decode of the file in memory, and every non-empty stream subset
   decodes with 12 residual-unit launches and no VQ search.
7. Exact chunked streaming at full width: a `StreamingFACodec` session of
   the phase-3 codec over batch 1 x 10 s in 16-frame (200 ms) chunks, then
   batch 4 x 10 s in 4-frame chunks (T < 6d at the d = 9 units of encoder
   stage 4 and decoder stage 1), through `roundtrip_chunk` and
   `flush_encode`, against the card's one-shot `encode` / `reconstruct` of
   the same wave and timbre (codes >= 0.99 equal, wave max abs <= 1e-3).
   Every steady chunk launches exactly 24 residual units through the
   kernel's halo entry and 6 VQ searches. Per-chunk wall latency, from the
   call until the chunk's wave is on the host (p50, p95, after 3 warm
   chunks), the realtime factor and the priming step's time; 10 further
   steady chunks run under torch.profiler, for the device kernels' time per
   chunk by kind (facodec_tpu_torch/profile.py), and are left out of p50
   and p95.
   7a holds the halo entry to its plain version at every flagship unit (C,
   d) for the chunk T of 16 and 4 frames at batch 1 and 4 (the inputs of
   one steady chunk of phase 7 where it ran that combination, captured
   with forward pre-hooks; random inputs of the same shape otherwise), and
   at T = 1, 53, 54, 55 at d = 9: max abs error <= 1e-5, new halo bit-equal.
   7b: `encode_streaming` of batch 1 x 40 s (80-frame chunks) against a
   one-shot encode (codes), `timbre_of` its first 10 s (timbre <= 1e-3),
   and `decode_streaming` against `decode` (<= 1e-3). 7c: a
   `StreamingRedecoder` at the FLAGSHIP_REDECODER widths made causal (a
   field override of this script), batch 1 x 10 s in 16-frame chunks,
   against `resynthesize` (<= 1e-3).

8. The `hybrid` codec (float32 encode, bf16-activation decode) at full
   width, batch 4 x 10 s, built on the phase-3 codec's modules: its codes
   equal the float32 codes, its decode is within err / scale 8e-2 of the
   float32 decode and within 2e-2 of a hybrid decode on the CPU (batch 1 x
   2 s, equal codes), both at the worst sample. One round trip launches 12 float32
   units (the encoder's), 12 bf16 units (the decoder's) and 6 VQ searches.
   Round-trip times against float32, in turns; the CUDA kernels one hybrid
   decode launches (a traced decode), with the units' kept packs of bf16
   operands and with each unit packing on every call. 8a holds the bf16
   entry (csrc/resunit_bf16.cu) to its plain version on the inputs of the
   12 decoder units of one hybrid decode (forward pre-hooks): no element
   more than 2 bf16 ulps off at `resunit.bf16_error_scale`, the kept pack
   giving the per-call pack's bits; per shape the kernel alone (one raw
   launch on the kept pack: device time of 200 launches in one CUDA graph,
   and one launch between two events), the wrapper call, the unit's call
   and the plain version, FLOP, the bf16 bound (989 TFLOP/s, or the bytes
   at 3.35 TB/s), what bounds it and the share reached, the tiling the
   kernel chose (N tile, rows, weight slice, ring stages, shared memory)
   and ptxas's registers and spills for that instantiation. In the kernels
   line, `ms` of `fused_residual_unit_bf16` is the 12 wrapper calls (as it
   was before the kernel kept its operands packed) and `kernel_ms` the 12
   kernels alone (the CUDA-graph device times).
9. `serve` in process: a `CodecService` over the hybrid codec (the serve
   default) behind `make_server` on 127.0.0.1:0. 8 concurrent 10 s
   /reconstruct requests inside a 200 ms batch window run as one device call
   of batch 8; each output is within err / scale 2e-2 of the same request
   sent alone at the worst sample. Then /encode -> /decode, /health,
   /metrics; requests per second concurrent and sequential. Any status but
   200 fails.
9a. Live streams. First a `BatchedStreamGroup` of capacity 8 alone, 4-frame
   (50 ms) chunks: tick times with 1, 4 and 8 active slots, and 10 ticks at
   8 slots under torch.profiler. Then a `StreamingService` with group
   capacity 8 behind `make_stream_server`, and 1 and 8 concurrent
   connections of 2 s each from a client process of their own (the port's
   `stream_wav` in threads, each sending as fast as it is answered):
   per-tick p50 / p95, slots per tick, each stream's time per chunk against
   the 50 ms of audio it carries; every stream's output within 1e-3 of a
   solo session; every tick launches 24 halo entries and 6 VQ searches.

10. Training at full width (`FLAGSHIP_TRAIN`: the codec, its predictor
   heads and its discriminator, seeded random weights). 10a: one training
   forward at batch 4 x 80 frames (PseudoDataset utterances of 1-30 s,
   cropped as the loop crops them); on the inputs of its 24 residual units
   (forward pre-hooks) the kernel's custom op (its registered gradient) against the plain
   composition's autograd, forward within phase 2a's limit and the
   gradients of x, both weights, both biases and both alphas within
   1e-4 x max|g|, with forward and forward+backward times; on its 6 VQ
   searches the codebook gradient against the plain gather's within
   1e-6 x max|g| and a zero latent gradient. 10b: one draws-off step of
   one seed on the CPU (plain versions) and on the card (kernels), batch
   1 x 20 frames: every loss and gradient norm within 1e-3 relative. 10c:
   `run_training(fields=FLAGSHIP_TRAIN, device="cuda")` with the JAX loop's
   defaults for 4 steps (the first a warm-up), a checkpoint at step 4 and a
   resume to step 5: the median step time, steps/s, seconds of audio per
   second, peak memory, exactly 24 residual-unit and 6 VQ launches a step,
   every loss finite, every module's parameters changed; then one steady
   step's device time per part (CUDA events at the step's phase marks) and
   one traced step by kind and kernel (`profile.train_profile`).
11. Redecoder training at full width (`FLAGSHIP_REDECODER_TRAIN`: the
   frozen flagship codec encoder and quantizer, seed 1; the published
   redecoder with dropout 0.2, its non-causal decoder and the
   discriminator, seed 0). 11a: one redecoder-training forward at batch
   4 x 80 frames; on the inputs of its 12 non-causal decoder units the
   kernel's custom op against the plain composition's autograd, as
   10a. 11b: one draws-off step, CPU against card, batch 1 x 20 frames,
   within 1e-3 relative. 11c: `run_redecoder_training(fields=
   FLAGSHIP_REDECODER_TRAIN, device="cuda")` for 4 steps (the first a
   warm-up), a checkpoint at step 4 and a resume to step 5: median step
   time, steps/s, audio seconds per second, peak memory, exactly 24
   residual-unit launches (12 frozen encoder units without a graph, 12
   decoder units through the Function) and 6 VQ searches a step, every loss
   finite, the three trained modules moved, the frozen codec bit-equal to
   its seeded weights; one steady step's parts and one traced step by
   kind. 11d: from one state and one generator seed, one step each of the
   fused, split and remat variants of the redecoder step and of the codec
   step (`FLAGSHIP_TRAIN`), dropout on: metrics within 1e-4 relative of the
   fused step, the peak memory of each, and the launches each variant
   adds (the split step's second generator forward, remat's recompute).

12. Training on one's own data, at full width. 12a: 10 seeded speech-like
   wavs (8 int16 24 kHz of 1-12 s, one 8-bit 16 kHz, one float64 stereo
   44.1 kHz) and a transcript; `assemble_data` splits them 8 / 2;
   `extract_targets --teachers jdc --device cuda` with a seeded JDC state
   dict in the reference layout (`{'net': sd}`, the detector branch and
   `num_batches_tracked` in it); each wav's F0 against a CPU teacher within
   1e-3 x max|F0|; the teacher's device time per second of audio. 12b:
   `run_training(fields=FLAGSHIP_TRAIN, dataset=FileListDataset(train.txt),
   F0_path=<that file>)` for 4 steps (it prints `inline F0 teacher`; 24
   residual-unit and 6 VQ launches a step, every loss finite); the step
   with the teacher against the same step fed the batch's F0, in turns
   (host clock), and the teacher's own device time on the batch's mel; one
   draws-off step with the teacher, card against CPU, batch 1 x 20 frames,
   within 1e-3 relative (10b's check); one split step with the teacher
   (48 / 12 launches). 12c: `evaluate.main` on val.txt with the flagship
   codec (every aggregate key finite, or null); `evaluate_utterance` on
   the 4 x 10 s waves under float32 (48 residual-unit launches, 6 VQ) and
   `hybrid` (12 float32, 36 bf16, 6 VQ), both scorecards, the SI-SDR of
   the hybrid reconstruction against the float32 one; one 1.5 s utterance
   card against CPU: codes >= 0.99 equal, every metric within the limits
   of `SCORECARD_TOL`.

13. AOT export and serving from an artifact (runs after 9a, on the phase-3
   codec's modules, seeded weights saved first as a port checkpoint):
   `export_codec` of a hybrid artifact (all five functions) and a float32
   one (`reconstruct_masked`; the hybrid artifact's encode is the float32
   encode, and its codes are held to both live codecs') at batch 4 x 10 s,
   export seconds per function and artifact bytes against the checkpoint's (the
   artifact must be smaller: it stores no parameter); `ExportedCodec` with
   `load_params` from the checkpoint and its first reconstruct (its
   program's load included) against `FACodec.from_fields` with the
   checkpoint and `CodecService.warmup()`; for both policies codes and
   timbre equal to the live codec's, `reconstruct_masked` within 1e-5 max
   abs (float32) or 1e-3 err/scale (hybrid) of live with the live path's
   launches (24 float32 units and 6 VQ; 12, 12 bf16 and 6), the hybrid
   artifact's encode, decode and reconstruct too, and reconstruct times,
   live then artifact, one each. 13b: an `ArtifactService` (batch 4)
   and a live `CodecService` of the same cap and bucket behind
   `make_server`, 8 concurrent 10 s /reconstruct requests to each in turns
   (live, artifact): requests/s, and each served wave within
   err / scale 2e-2 of the live hybrid codec's on the same request.
14. Training and serving over several GPUs (parallel/; runs last).
   14a: `run_training(fields=FLAGSHIP_TRAIN)` as torchrun starts it, in
   this process as rank 0 of an NCCL group of gcd(4, visible GPUs) ranks
   (one on a one-card machine: then the reduce is an identity), on 4
   PseudoDataset utterances (one batch of 4 x 80 frames an epoch), draws
   on, under PyTorch's and cuDNN's deterministic algorithms, in turns:
   plain (3 steps), data-parallel cut at step 2 after rank 0's epoch
   checkpoint at step 1, data-parallel resumed from it to step 3, plain
   again; parameters and metrics bit-equal, step ms of both, the
   all-reduce's ms a step (CUDA events around each `all_reduce_mean_`) and
   bytes, 24 residual-unit and 6 VQ launches a step; where more GPUs are
   visible, that many spawned NCCL ranks as 14b.
   Every `run_training` of 14 and 17a draws FLAGSHIP_TRAIN's seeded
   weights once per process and loads them in later builds
   (`reused_build`: the same values).
   14b: two spawned ranks on cuda:0 over gloo, each running `run_training`
   on its 2 rows of every 4-row batch, fused (2 steps, rank 0 writes a
   checkpoint at step 1) and split (1 step), against the same runs in one
   process: the rows each rank kept, the last step's gradients (as the
   updates took them) within 1e-4 of max|g| per module, metrics and
   parameters within rtol 2e-3 atol 2e-4, each rank's launches equal to
   the one process's (a rank other than 0 returns digests of its
   gradients and parameters, held to rank 0's); each collective's calls
   and host ms in the last step, timed as 17a's are (a synchronise before
   and after each), so that the two layouts' step ms compare; the same
   ranks then run 17a's tensor-parallel runs.
   14c: `run_redecoder_training` as 14a (plain 2 steps, data-parallel cut
   at 2 with a checkpoint at 1, resumed from it), bit-equal. 14d:
   `shard_inference` of FLAGSHIP (float32 and hybrid) and
   FLAGSHIP_REDECODER at batch 3 x 10 s, over every visible GPU and over
   two replicas on cuda:0: codes equal, timbre and float32 waves within
   1e-5 of the unsharded call's, hybrid within 2e-2 err/scale of it (a
   replica decodes another batch: HYBRID_BF16) and within 1e-3 of the
   unsharded codec on each replica's rows, launches per replica, ms against
   unsharded in turns. 14e: a `CodecService` over two hybrid replicas on
   cuda:0 against an unsharded one (max batch 8), 8 concurrent 10 s
   /reconstruct requests to each in turns: responses within 2e-2
   err/scale (4 + 4 rows against 8), requests/s.
15. The precision policies `bfloat16` and `hybrid_int8` at full width,
   batch 4 x 10 s, on the phase-3 codec's modules (runs after phase 8a).
   15a holds the bf16 kernel's float32-in/out forms (csrc/resunit_bf16.cu)
   to their plain versions: the `bfloat16` form on the inputs of the 24
   units of one `bfloat16` round trip, the act form on the 3 C = 384 units
   of one `hybrid_int8` decode (forward pre-hooks): <= 2 bf16 ulps at
   `resunit.bf16_error_scale`. 15b holds the int8 unit (csrc/resunit_int8.cu,
   two launches: row maxima, unit) to its plain version on the 3 C = 768
   units of that decode: the row maxima, the quantized padded input and
   the conv7 output bit-equal, the output <= 2 bf16 ulps. Per shape: the
   kernel's device time (50 launches in one CUDA graph; per dilation also
   the unit alone and its share of its bound), the wrapper's
   (`fused_residual_unit` under the policy, packing per call) and the
   plain version's, the bound (the bf16 forms: 16 C^2 FLOP a row at 989
   TFLOP/s or the bytes at 3.35 TB/s; the int8 unit: 14 C^2 int8
   operations a row at 1979 TOPS plus 2 C^2 FLOP at 989 TFLOP/s). 15c: round
   trips under float32, hybrid, bfloat16 and hybrid_int8 in turns (times),
   each policy's launches (bfloat16: 24 float32-in/out units and 6 VQ
   searches; hybrid_int8: 12 float32 units, 3 + 3 int8 launches, 3 act
   units, 6 bf16 units and 6 VQ searches), the share of bfloat16 codes
   equal to float32's (>= 0.9), hybrid_int8's codes and timbre equal to
   float32's, each wave's SI-SDR against the float32 wave, and for each
   policy the card's decode against the CPU's on equal codes (batch 1 x
   2 s, err / scale <= 2e-2 at the worst sample).
16. The port's benchmarks, as `python -m facodec_tpu_torch bench ...` runs
   them (their `main`; each prints its JSON line), each between a reset and
   a read of the kernels' counts (runs after phase 15). 16a: `bench --fast`
   under hybrid_int8, float32 and hybrid, batch 16 x 10 s: 11 round trips
   each (one run of 10 after the warm-up, where the bench makes 3), every one launching its policy's kernels (phase 15c's counts), and
   0 < mfu <= 1. 16b: `bench streaming --fast`, 2 s of 4-frame chunks, the
   causal redecoder and a group of 8: the halo entry and the VQ search
   launched, the one-shot entry not, a device time read from its trace.
   16c: `bench train --fast`, FLAGSHIP_TRAIN at 4 x 80 frames, 4 steps: 24
   residual-unit and 6 VQ launches a step. 16d: a traced hybrid and
   hybrid_int8 round trip at 4 x 10 s through `utils.profiling.trace` and
   `aggregate_device_trace` (`profile.round_trip_profile`): device time by
   kind, by kernel and by annotated range (encode, quantize, decode); no
   residual-unit or VQ kernel of kind "other"; the trace's launches by form
   (hybrid: 12 `resunit_kernel`, 12 `resunit_bf16_kernel`; hybrid_int8: 12,
   6 bf16 and 3 act forms, 3 + 3 int8; both 6 VQ searches of two kernels)
   equal to the wrappers' counts; W8A8 GEMMs under hybrid_int8 only.
17. The entry points of tensor-parallel training, `validate` and the webui
   (after phase 14, whose 14b ranks and one-process runs 17a reuses). 17a:
   14b's two gloo ranks on cuda:0 run `run_training(fields=FLAGSHIP_TRAIN,
   tensor_parallel=2)`, data 1 x model 2 (the speaker heads, the phone
   heads and `timbre_linear` split by rows), fused (2 steps, a checkpoint
   at step 1) and split (1 step), held to 14b's one-process runs with 14b's
   tolerances (the gradients and parameters gathered whole); each rank's
   step ms, its bytes of the sharded tensors and of all parameters and
   moments against the whole, each collective's calls and host ms in the
   last step (a synchronise before and after each); then one process
   resumes the tensor-parallel checkpoint (whole tensors) and gives the
   one-process step. 17b: `validate` (its `main`) on the card at FLAGSHIP
   width from a seeded checkpoint in the reference's layout and a golden
   the port computes on the CPU: its JSON line and exit code as they are,
   codes >= 0.99 equal to the golden's, mel_l1 within the threshold. 17c:
   the webui handlers at FLAGSHIP width, `do_reconstruct` on 10 s of int16
   at 16 kHz and `do_convert` on two 3 s clips, against the same handlers
   on the CPU within 33 LSB (1e-3 of full scale), with their ms.
18. The opt-in W8A8 LSTM recurrence (csrc/lstm_int8.cu) with
   FACODEC_LSTM_INT8=1 set inside this phase only (every other phase runs
   without it, and the kernel's count reads 0 before and after it); it
   runs after phase 13, on the phase-3 codec's modules. 18a: the kernel
   against its plain version on the operands of the flagship decoder's 2
   layers in one hybrid decode at 4 x 10 s (B = 4, T = 800, H = 1536,
   captured at the SLSTM's call): y and hT within 1e-3, cT within 2e-3,
   the share of y bit-equal; per layer the kernel's time (median of events
   around one launch), the plain version's, the int8 operations and bytes,
   the bound (1979 int8 TOPS or 3.35 TB/s), one grid barrier's time (a
   launch of T barriers alone on the same grid) and the serial floor (T of
   them). 18b: hybrid and hybrid_int8 round trips at 4 x 10 s without and
   with the flag: the decode launches the kernel 0 and 2 times and the other
   kernels alike; codes and timbre equal (the encode is float32); the
   flagged wave's gap to the flagless; the decoder LSTM's device time each
   way (cuDNN; the projections and the kernel), the decode's in turns; the
   flagged hybrid decode on the card against the flagged CPU decode at
   1 x 2 s within phase 8's 2e-2 err / scale. 18c: a `StreamingFACodec`
   decode of the 4 x 10 s latent under bfloat16_act and the flag, in
   4-frame chunks after the decoder's first span: 2 launches a chunk; the
   wave against the flagged one-shot hybrid decode within phase 8's 8e-2
   err / scale for decodes that round apart (the stream's residual units
   run float32, the one-shot's bf16); the SLSTM's streamed output and final (h, c), captured with
   hooks, against one shot on the same input within 1e-5, bit-equality
   said. 18d: a traced hybrid_int8 round trip under the flag
   (`profile.round_trip_profile`): the kernel's kind and 2 launches in the
   trace and the wrapper, no cuDNN LSTM in the decode. 18e: the hybrid
   `decode` exported with the flag set at 4 x 10 s: 2 `facodec::lstm_int8`
   nodes and no `aten.lstm`, 2 launches a call with the flag unset, the
   wave within phase 13's 1e-3 err / scale of the live flagged decode.

19. bf16 training and the legacy 4-stream quantizer. 19a (after 10a, on
   its models and batch): the inputs of the 24 residual units of one
   FLAGSHIP_TRAIN training forward at 4 x 80 frames under `bfloat16` and
   under `bfloat16_act` (forward pre-hooks), each through its policy's bf16
   kernel form with gradients (`bfloat16`: the float32-in/out form,
   `bfloat16_act`: the bf16 entry; a pack made per call, as in training)
   and through the plain composition's autograd: one launch of the form and
   none of the float32 entry, the forward within 2 bf16 ulps at
   `resunit.bf16_error_scale`, the gradients of x, both weights, both
   biases and both alphas within 1e-4 x max|g| (both under deterministic
   algorithms: the backward is the plain composition recomputed from the
   saved pack); forward and forward+backward ms of both, FLOP and the bf16
   bound. 19c (after 19a, on the same models from their seeded state): 4
   steps (one warm-up) of the fused step under float32, bfloat16 and
   bfloat16_act at 4 x 80 frames: launches a step (24 units in the policy's
   form, 0 in the float32 entry under a bf16 policy, 6 VQ), every loss
   finite, every module's parameters float32 and moved, step ms and peak
   memory, one traced step by kind. 19b (inside 10b, on its models): the
   same draws-off step at 1 x 20 frames under each bf16 policy, card
   against CPU, every loss within 2e-2 relative, the gradient norms'
   gaps printed. 19d (after 18, on the phase-3 codec's encoder):
   `FAquantizer(timbre_norm=False)` at the flagship quantizer's width on
   the 4 x 10 s latent: `forward_v1` at n_c = 2 launches the VQ kernel 8
   times; `encode` codes (c, p, t, r) >= 0.99 equal to a CPU copy's,
   `decode` of equal codes within 1e-3; their card ms.

The line before the last is the kernels' JSON summary; the last line is the
run's JSON result. The kernels' `train_launches` are a training step's,
`train_ms` their device time in the traced step, `train_grad_max_rel` the
worst gradient gap of phase 10a; `redecoder_train_launches`,
`redecoder_train_ms` and `redecoder_grad_max_rel` are the same for the
redecoder step (11c, 11a); `teacher_train_launches` are a step's with the
inline teacher (12b), `eval_launches` one `evaluate_utterance`'s (12c;
under `hybrid` for the bf16 entry) and `artifact_launches` one
`reconstruct_masked` of the float32 artifact (the bf16 entry: of the hybrid
one; the float32 entry's `artifact_hybrid_launches` are the hybrid one's).
`dp_step_launches` are one rank's a data-parallel step (14a),
`dp_gloo_step_launches` one gloo rank's (14b), `sharded_reconstruct_launches`
and `sharded_hybrid_launches` one replica's in a sharded float32 and hybrid
reconstruct (14d, two replicas on cuda:0). The phase-15 kernels' `ms` is
the kernel alone (device time), `wrapper_ms` the wrapper's per-call-pack
call; `launches` are those of one round trip under their policy.
`bench_launches` are a kernel's launches in one round trip of the bench
(16a), by policy; `bench_train_launches` a step's of `bench train` (16c).
`tp_step_launches` are one rank's a tensor-parallel step (17a),
`validate_launches` one `validate` call's (17b: an encode and a
reconstruct), `webui_reconstruct_launches` and `webui_convert_launches`
one call of each handler (17c); every kernel's are read from its counter
in those runs (all float32: 0 for the bf16, float32-in/out and int8 forms).
Phase 19 adds, for every kernel, `bf16_train_launches` (its launches a
19c step under `bfloat16` and `bfloat16_act`); for the bf16 entry
(`bfloat16_act`) and the float32-in/out form (`bfloat16`) their training
numbers: `bf16_train_ms` (device time in the traced 19c step),
`train_grad_max_rel` and `train_fwd_ulps` (19a), `train_fwd_ms`,
`train_fwd_plain_ms`, `train_fwd_bwd_ms`, `train_fwd_bwd_plain_ms`,
`train_flops`, `train_bound_ms` and `train_bound_by` (19a's 24 units); for
the VQ search `v1_launches` (19d's `forward_v1`).
The `lstm_int8` entry (phase 18) is not a TPU kernel's port: `replaces`
names the JAX package's XLA scan; `launches` are a flagged hybrid decode's,
`ms`, `plain_ms` and `bound_ms` the decoder's two layers', `library_ms`
null (no PyTorch call computes it) and `cudnn_lstm_ms` the flagless
decoder LSTM's (cuDNN, another function: float32 weights, no quantization).
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings

import numpy as np
import torch

from facodec_tpu_torch.api import FACodec, FARedecoder, convert_voice, float32_exact
from facodec_tpu_torch.cli import serve as serve_cli
from facodec_tpu_torch.cli import stream_serve
from facodec_tpu_torch.codec_file import FACodecFile
from facodec_tpu_torch.config import (FLAGSHIP, FLAGSHIP_REDECODER, FLAGSHIP_REDECODER_TRAIN,
                                      FLAGSHIP_TRAIN)
from facodec_tpu_torch.models.dac import ResidualUnit
from facodec_tpu_torch.models.streaming import HOP, StreamingFACodec, min_first_frames_decoder
from facodec_tpu_torch.models.quantize import ResidualVectorQuantize, VectorQuantize
from facodec_tpu_torch.nn import lstm as nn_lstm
from facodec_tpu_torch.nn.lstm import SLSTM
from facodec_tpu_torch.ops import vq_math
from facodec_tpu_torch.ops.precision import policy
from facodec_tpu_torch.ops.kernels import build, resunit, vq
from facodec_tpu_torch.ops.kernels import lstm as klstm
from facodec_tpu_torch.parallel import mesh, ranks
from facodec_tpu_torch.profile import RESUNIT_BF16, RESUNIT_F32, RESUNIT_INT8
from facodec_tpu_torch.profile import VQ as PROFILE_VQ
from facodec_tpu_torch.profile import LSTM_INT8 as LSTM_INT8_KIND
from facodec_tpu_torch.profile import W8A8_GEMM as W8A8_KIND
from facodec_tpu_torch.profile import device_ms as traced_device_ms
from facodec_tpu_torch.profile import kind_of, print_breakdown, round_trip_profile, train_profile
from facodec_tpu_torch.train.data import PseudoDataset, collate, segment_batch, to_device
from facodec_tpu_torch.train.loop import build_models, latest_checkpoint, run_training
from facodec_tpu_torch.train.optimizers import build_optimizers
from facodec_tpu_torch.train.redecoder_loop import (build_frozen_codec, build_redecoder_models,
                                                    run_redecoder_training)
from facodec_tpu_torch.train.redecoder_step import (frozen_encode, make_redecoder_train_step,
                                                    make_redecoder_train_step_split,
                                                    redecoder_forward)
from facodec_tpu_torch.train.step import (gen_forward, make_codec_train_step,
                                          make_codec_train_step_split)
from facodec_tpu_torch.utils import export
from facodec_tpu_torch.utils.signals import sweep_wave

SR = 24000
BATCH = 4
SECONDS = 10.0
# Kernel 1 against its plain version: both sum in float32, in another order.
RESUNIT_TOL = 1e-4  # rtol = atol
# Kernel 2: indices equal except where the plain top-2 distance gap is below
# VQ_TIE_GAP (a float32 near-tie), in at most VQ_TIE_SHARE of the rows; the
# gathered rows equal exactly where the indices agree.
VQ_TIE_GAP = 1e-6
VQ_TIE_SHARE = 1e-3
# Phase 4: codes of the card against the CPU, and the decode of equal codes.
CODE_MATCH_MIN = 0.99
DECODE_MAX_DIFF = 1e-3
REPEATS = 10
GRAPH_LAUNCHES = 200  # calls per CUDA graph for a device time per call
RESUNIT_MAX_ERR = 1e-5  # the kernel's float32 sums against the plain version's
# Published peaks of one H100 SXM (dense): the roofline of each kernel.
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12
# The bf16 entry against its plain version (tests/test_torch_precision.py).
BF16_MAX_ULPS = 2
# A bf16 decode against another evaluation of it (the CPU's, another
# batch's): two orders of summation flip roundings, and a flip moves every
# later layer's input, so the worst sample differs by a few output ulps.
# err / scale at the worst sample; the RMS is printed beside it.
HYBRID_BF16 = 2e-2
# The hybrid decode against the float32 decode: the JAX package's limit
# (tests/test_precision.py).
HYBRID_VS_F32 = 8e-2


_START = time.perf_counter()


def log(msg: str) -> None:
    """Print one line; a phase's header carries the seconds since the start."""
    if msg.startswith("phase "):
        msg = f"[{time.perf_counter() - _START:.1f} s] {msg}"
    print(msg, flush=True)


def median_ms(fn, repeats: int = REPEATS) -> float:
    fn()  # warm-up
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def unit_inputs(parts, run, expected: int) -> list:
    """(unit, x) for every ResidualUnit call of `parts` while `run()` runs."""
    calls = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: calls.append((mod, args[0])))
             for part in parts for m in part.modules() if isinstance(m, ResidualUnit)]
    run()
    for h in hooks:
        h.remove()
    if len(calls) != expected:
        raise AssertionError(f"{len(calls)} residual-unit calls, expected {expected}")
    return calls


POLICY_COUNTERS = dict(f32="launches", bf16="bf16_launches", f32io="f32io_launches",
                       act="f32io_act_launches", amax="int8_amax_launches",
                       int8="int8_launches")


def reset_counts() -> None:
    for attr in POLICY_COUNTERS.values():
        setattr(resunit.fused_residual_unit, attr, 0)
    resunit.fused_residual_unit_stream.launches = 0
    vq.nearest_code.launches = 0


def all_counts() -> dict:
    return dict(f32=resunit.fused_residual_unit.launches,
                bf16=resunit.fused_residual_unit.bf16_launches,
                halo=resunit.fused_residual_unit_stream.launches, vq=vq.nearest_code.launches)


def wave_gap(got: np.ndarray, want: np.ndarray) -> tuple:
    """(worst-sample err / scale, RMS err / RMS) of two waves."""
    worst = float(np.abs(got - want).max() / np.abs(want).max())
    rms = float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))
    return worst, rms


def check_hybrid_gap(label: str, got: np.ndarray, want: np.ndarray) -> tuple:
    worst, rms = wave_gap(got, want)
    log(f"  {label}: err/scale {worst:.3e} at the worst sample (limit {HYBRID_BF16}), "
        f"{rms:.3e} in RMS")
    if not worst <= HYBRID_BF16:
        raise AssertionError(f"{label}: err/scale {worst} > {HYBRID_BF16}")
    return worst, rms


def counts() -> tuple:
    """(one-shot residual-unit launches, VQ launches); the halo entry's
    are `stream_count()`."""
    return resunit.fused_residual_unit.launches, vq.nearest_code.launches


def stream_count() -> int:
    return resunit.fused_residual_unit_stream.launches


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"device: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.build()
    for name in build.SOURCES:
        build.library(name)
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if any(k in line for k in ("registers", "spill", "entry function", "warning")):
                log(f"  ptxas {name}: {line.strip()}")
    return smi


def resunit_cost(B: int, T: int, C: int) -> tuple:
    """(FLOP, bytes) of one residual unit: 2 * 8 * C^2 FLOP per row (conv7 and
    1x1); x read once, out written once, the weights, biases and alphas once."""
    return 16 * B * T * C * C, 4 * (2 * B * T * C + 8 * C * C + 4 * C)


def bound_ms(flop: float, nbytes: float, peak_flops: float) -> float:
    return 1e3 * max(flop / peak_flops, nbytes / HBM_BYTES_S)


def phase_resunit(title: str, calls: list) -> dict:
    """Each captured unit input through the kernel and the plain version."""
    log(f"{title}, rtol=atol={RESUNIT_TOL}, max_abs_err <= {RESUNIT_MAX_ERR}; bounds at "
        f"{FP32_FLOPS / 1e12:.0f} TFLOP/s float32 (CUDA cores) and 3 x FLOP at "
        f"{TF32_FLOPS / 1e12:.0f} TFLOP/s TF32 (3xTF32 route)")
    worst = 0.0
    tot = dict(ms=0.0, plain_ms=0.0, flops=0, bound_ms=0.0, bound_fp32_ms=0.0)
    for unit, x in calls:
        snake1, conv7, snake2, conv1 = unit.block
        with torch.no_grad(), float32_exact():
            args = (x.contiguous(), conv7.effective_weight(), conv7.bias,
                    conv1.effective_weight(), conv1.bias, snake1.alpha, snake2.alpha,
                    unit.dilation, unit.causal)
            got = resunit.fused_residual_unit(*args)
            want = resunit.residual_unit_reference(*args)
            exact = resunit.residual_unit_reference(
                *(a.double() for a in args[:7]), unit.dilation, unit.causal)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            err64 = (got.double() - exact).abs().max().item()
            plain64 = (want.double() - exact).abs().max().item()
            del exact
            torch.testing.assert_close(got, want, rtol=RESUNIT_TOL, atol=RESUNIT_TOL)
            if not err <= RESUNIT_MAX_ERR:
                raise AssertionError(f"max_abs_err {err} > {RESUNIT_MAX_ERR}")
            tk = median_ms(lambda: resunit.fused_residual_unit(*args))
            tp = median_ms(lambda: resunit.residual_unit_reference(*args))
        B, T, C = x.shape
        flop, nbytes = resunit_cost(B, T, C)
        b3 = bound_ms(3 * flop, nbytes, TF32_FLOPS)
        b1 = bound_ms(flop, nbytes, FP32_FLOPS)
        worst = max(worst, err)
        for k, v in (("ms", tk), ("plain_ms", tp), ("flops", flop), ("bound_ms", b3),
                     ("bound_fp32_ms", b1)):
            tot[k] += v
        log(f"  B={B} C={C:4d} T={T:6d} d={unit.dilation} {'causal' if unit.causal else 'noncausal'}: "
            f"max|x| {x.abs().max().item():.3e} "
            f"FLOP {flop:.4e} bound {b1:.3f} ms fp32 / {b3:.3f} ms 3xtf32; "
            f"kernel {tk:.3f} ms ({flop / tk / 1e9:.1f} TFLOP/s) plain {tp:.3f} ms; "
            f"max_abs_err vs plain {err:.3e}, vs float64: kernel {err64:.3e} plain {plain64:.3e}")
    log(f"  {len(calls)} units: kernel {tot['ms']:.3f} ms plain {tot['plain_ms']:.3f} ms; bound "
        f"{tot['bound_fp32_ms']:.3f} ms fp32 ({tot['bound_fp32_ms'] / tot['ms']:.1%} of it reached) "
        f"/ {tot['bound_ms']:.3f} ms 3xtf32 ({tot['bound_ms'] / tot['ms']:.1%})")
    return dict(max_abs_err=worst, **tot)


def _vq_check(lat: torch.Tensor, cb: torch.Tensor, label: str) -> tuple:
    idx, zq = vq.nearest_code(lat, cb)
    want_idx, want_zq = vq_math.nearest_code(lat, cb)
    dist = vq_math.code_distances(lat, cb)
    top2 = torch.topk(dist, 2, dim=-1, largest=False).values
    near_tie = (top2[:, 1] - top2[:, 0]) < VQ_TIE_GAP
    differ = idx != want_idx
    n_diff = int(differ.sum())
    if bool((differ & ~near_tie).any()):
        raise AssertionError(f"VQ {label}: {int((differ & ~near_tie).sum())} rows differ "
                             f"outside a near-tie")
    if n_diff > VQ_TIE_SHARE * lat.shape[0]:
        raise AssertionError(f"VQ {label}: {n_diff} near-tie rows differ, over the allowance")
    agree = ~differ
    if not torch.equal(zq[agree], want_zq[agree]):
        raise AssertionError(f"VQ {label}: gathered rows differ where the indices agree")
    err = (zq[agree] - want_zq[agree]).abs().max().item() if bool(agree.any()) else 0.0
    log(f"  {label}: M={lat.shape[0]} rows, {n_diff} differ (near-ties, gap < {VQ_TIE_GAP}), "
        f"zq max_abs_err {err:.3e}")
    return idx, n_diff, err


def device_ms(fn, launches: int = GRAPH_LAUNCHES) -> float:
    """Device time per call of fn: `launches` calls captured in one CUDA graph,
    the graph replayed between two events, over the count (median of
    REPEATS replays). The graph takes the host out of the timing."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return median_ms(graph.replay) / launches


def vq_inputs(codec: FACodec, w: np.ndarray) -> list:
    """(name, codebook, latents (M, 8)) for every nearest_code call in one
    encode of w, in call order (forward hooks on each quantizer's in_proj,
    whose output is what the search receives)."""
    calls = []
    hooks = [vqm.in_proj.register_forward_hook(
        lambda mod, args, out, name=name, vqm=vqm: calls.append(
            (name, vqm.codebook.weight.detach(), out.detach().reshape(-1, out.shape[-1]))))
        for name, vqm in codec.quantizer.named_modules() if isinstance(vqm, VectorQuantize)]
    codec.encode(w)
    for h in hooks:
        h.remove()
    return calls


def vq_cost(M: int, K: int, D: int) -> tuple:
    """(FLOP, bytes) of one search: e.c for every pair and the two norms;
    latents and codebook read once, rows and indices written once."""
    return 2 * M * K * D + 2 * (M + K) * D, 4 * (2 * M * D + K * D + M)


def phase_vq(codec: FACodec, w: np.ndarray) -> dict:
    log(f"phase 2b: nearest_code vs plain, first-index ties, gap < {VQ_TIE_GAP} allowed "
        f"in <= {VQ_TIE_SHARE:.1%} of rows; device time = {GRAPH_LAUNCHES} calls in one CUDA "
        f"graph / {GRAPH_LAUNCHES}, wrapper time = one call between two events (median of "
        f"{REPEATS}); bound at {FP32_FLOPS / 1e12:.0f} TFLOP/s float32 (CUDA cores)")
    calls = vq_inputs(codec, w)
    if len(calls) != 6:
        raise AssertionError(f"one encode called nearest_code {len(calls)} times, expected 6")
    gen = torch.Generator(device="cuda").manual_seed(2)
    cb = codec.quantizer.content_quantizer.quantizers[0].codebook.weight.detach().contiguous()
    M = BATCH * int(SECONDS * SR / 300)
    lat = torch.randn(M, cb.shape[1], device="cuda", generator=gen)
    worst = 0.0
    tot = dict(ms=0.0, wrapper_ms=0.0, plain_ms=0.0, plain_wrapper_ms=0.0, flops=0, bound_ms=0.0)
    with torch.no_grad(), float32_exact():
        for name, book, x in calls:
            _, _, err = _vq_check(x, book, name)
            worst = max(worst, err)
            tk = device_ms(lambda: vq.nearest_code(x, book))
            tw = median_ms(lambda: vq.nearest_code(x, book))
            tp = device_ms(lambda: vq_math.nearest_code(x, book))
            tpw = median_ms(lambda: vq_math.nearest_code(x, book))
            flop, nbytes = vq_cost(x.shape[0], *book.shape)
            b = bound_ms(flop, nbytes, FP32_FLOPS)
            for k, v in (("ms", tk), ("wrapper_ms", tw), ("plain_ms", tp),
                         ("plain_wrapper_ms", tpw), ("flops", flop), ("bound_ms", b)):
                tot[k] += v
            log(f"    M={x.shape[0]} N={book.shape[0]}: FLOP {flop:.4e} bytes {nbytes} bound "
                f"{b * 1e3:.3f} us; kernel device {tk * 1e3:.2f} us ({b / tk:.2%} of the bound), "
                f"wrapper {tw * 1e3:.2f} us; plain device {tp * 1e3:.2f} us, one call "
                f"{tpw * 1e3:.2f} us")
        n = len(calls)
        log(f"  mean of the {n} main-path calls: kernel device {tot['ms'] / n * 1e3:.2f} us "
            f"({tot['bound_ms'] / tot['ms']:.2%} of the bound), wrapper "
            f"{tot['wrapper_ms'] / n * 1e3:.2f} us; plain device {tot['plain_ms'] / n * 1e3:.2f} us")
        _, _, err = _vq_check(lat, cb, "random latents")
        worst = max(worst, err)
        dup = cb.clone()
        dup[700], dup[901] = dup[10], dup[3]
        lat_dup = lat.clone()
        lat_dup[: M // 2] = 2.5 * dup[10]
        lat_dup[M // 2:] = 0.5 * dup[3]
        idx, _, _ = _vq_check(lat_dup, dup, "duplicated codebook rows")
        if not (bool((idx[: M // 2] == 10).all()) and bool((idx[M // 2:] == 3).all())):
            raise AssertionError("VQ: duplicated rows did not resolve to the first index")
    # per launch: the means over the main path's calls
    return dict(max_abs_err=worst, **{k: v / n for k, v in tot.items()})


def phase_slice(codec: FACodec, w: np.ndarray) -> dict:
    """Runs after phase 2a, whose reconstruct of the same w warmed the path up."""
    B = w.shape[0]
    log(f"phase 3: flagship round trip, batch {B} x {SECONDS:.0f} s, float32")
    frames = int(SECONDS * SR / 300)

    reset_counts()
    t0 = time.perf_counter()
    codes = codec.encode(w)
    y = codec.decode(codes)
    torch.cuda.synchronize()
    rt = time.perf_counter() - t0
    rt_counts = counts()
    log(f"  encode -> decode: {rt:.3f} s, {B * SECONDS / rt:.1f}x realtime; "
        f"launches resunit {rt_counts[0]} vq {rt_counts[1]}")
    if rt_counts != (24, 6):
        raise AssertionError(f"encode -> decode launched {rt_counts}, expected (24, 6)")
    shapes = (codes.codes_p.shape, codes.codes_c.shape, codes.codes_r.shape, codes.timbre.shape)
    want = ((B, 1, frames), (B, 2, frames), (B, 3, frames), (B, 1024))
    if shapes != want:
        raise AssertionError(f"code shapes {shapes}, expected {want}")
    if y.shape != (B, int(SR * SECONDS)) or not np.isfinite(y).all():
        raise AssertionError(f"decoded wave {y.shape} is not a finite (4, 240000) wave")

    t0 = time.perf_counter()
    r = codec.reconstruct(w)
    torch.cuda.synchronize()
    rt_rec = time.perf_counter() - t0
    total = counts()
    log(f"  reconstruct: {rt_rec:.3f} s, {B * SECONDS / rt_rec:.1f}x realtime; "
        f"launches resunit {total[0] - rt_counts[0]} vq {total[1] - rt_counts[1]}")
    if total != (48, 12):
        raise AssertionError(f"reconstruct launched {(total[0] - 24, total[1] - 6)}, "
                             f"expected (24, 6)")
    if r.shape != y.shape or not np.isfinite(r).all():
        raise AssertionError(f"reconstructed wave {r.shape} is not finite (4, 240000)")
    log(f"  wave rms in {float(np.sqrt(np.mean(w ** 2))):.4f} out {float(np.sqrt(np.mean(y ** 2))):.4f}")
    return dict(resunit=rt_counts[0], vq=rt_counts[1], roundtrip_s=rt, reconstruct_s=rt_rec)


def phase_cpu(codec: FACodec) -> FACodec:
    """Returns the CPU codec, for phase 8."""
    log("phase 4: card against CPU, flagship weights, batch 1 x 2 s")
    cpu = FACodec.from_fields(FLAGSHIP, seed=0, device="cpu")
    w = sweep_wave(1, 2.0, seed=3)
    t0 = time.perf_counter()
    c_cpu = cpu.encode(w)
    c_gpu = codec.encode(w)
    names = ("codes_p", "codes_c", "codes_r")
    same = sum(int((getattr(c_cpu, n) == getattr(c_gpu, n)).sum()) for n in names)
    total = sum(getattr(c_cpu, n).size for n in names)
    match = same / total
    y_cpu = cpu.decode(c_cpu)
    y_gpu = codec.decode(c_cpu)
    diff = float(np.abs(y_cpu - y_gpu).max())
    t_diff = float(np.abs(c_cpu.timbre - c_gpu.timbre).max())
    log(f"  code match {match:.5f} ({same}/{total}), timbre max diff {t_diff:.3e}, "
        f"decode of the same codes max abs diff {diff:.3e} ({time.perf_counter() - t0:.1f} s)")
    if match < CODE_MATCH_MIN:
        raise AssertionError(f"code match {match} < {CODE_MATCH_MIN}")
    if not diff <= DECODE_MAX_DIFF:
        raise AssertionError(f"decode difference {diff} > {DECODE_MAX_DIFF}")
    return cpu


def phase_vc(codec_vc: FACodec, red: FARedecoder, w: np.ndarray, target: np.ndarray,
             smi: str) -> tuple:
    """Two counted convert_voice runs, the second one warm, then its parts
    timed one by one. Returns the launch counts, the codes and the timbre."""
    B = w.shape[0]
    log(f"phase 5: convert_voice, FLAGSHIP_REDECODER, source and target batch {B} x "
        f"{SECONDS:.0f} s, float32 ({smi})")
    for run in ("first", "second"):
        reset_counts()
        t0 = time.perf_counter()
        y = convert_voice(codec_vc, red, w, target)
        torch.cuda.synchronize()
        rt = time.perf_counter() - t0
        vc_counts = counts()
        log(f"  {run} call: {rt:.3f} s, {B * SECONDS / rt:.1f}x realtime; "
            f"launches resunit {vc_counts[0]} vq {vc_counts[1]}")
        if vc_counts != (36, 10):
            raise AssertionError(f"convert_voice launched {vc_counts}, expected (36, 10)")
        if y.shape != (B, int(SR * SECONDS)) or not np.isfinite(y).all():
            raise AssertionError(f"converted wave {y.shape} is not a finite (4, 240000) wave")
    log(f"  wave rms source {float(np.sqrt(np.mean(w ** 2))):.4f} "
        f"out {float(np.sqrt(np.mean(y ** 2))):.4f}")
    parts = []

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts.append(f"{name} {time.perf_counter() - t0:.3f} s")
        return out

    codes = timed("encode source", lambda: codec_vc.encode(w))
    timbre = timed("timbre_of target", lambda: codec_vc.timbre_of(target))
    timed("resynthesize", lambda: red.resynthesize(codes, timbre))
    log(f"  its parts, one call each: {', '.join(parts)}")
    return vc_counts, codes, timbre


def phase_vc_cpu(codec_vc: FACodec, red: FARedecoder) -> None:
    log("phase 6: voice conversion card against CPU, FLAGSHIP_REDECODER seed 1, batch 1 x 2 s, "
        "the same source codes and target timbre")
    cpu = FARedecoder.from_fields(FLAGSHIP_REDECODER, seed=1, device="cpu")
    codes = codec_vc.encode(sweep_wave(1, 2.0, seed=6))
    timbre = codec_vc.timbre_of(sweep_wave(1, 2.0, seed=7))
    t0 = time.perf_counter()
    y_cpu = cpu.resynthesize(codes, timbre)
    y_gpu = red.resynthesize(codes, timbre)
    diff = float(np.abs(y_cpu - y_gpu).max())
    log(f"  max abs wave difference {diff:.3e} ({time.perf_counter() - t0:.1f} s)")
    if not diff <= DECODE_MAX_DIFF:
        raise AssertionError(f"VC card vs CPU difference {diff} > {DECODE_MAX_DIFF}")


def phase_fac(codec: FACodec, w: np.ndarray) -> None:
    log(f"phase 6a: .fac on the card, batch {w.shape[0]} x {SECONDS:.0f} s")
    f = codec.encode(w)
    blob = f.to_bytes()
    g = FACodecFile.from_bytes(blob)
    for name in ("codes_p", "codes_c", "codes_r", "timbre"):
        if not np.array_equal(getattr(f, name), getattr(g, name)):
            raise AssertionError(f".fac round trip changed {name}")
    y, y_file = codec.decode(f), codec.decode(g)
    if not np.array_equal(y, y_file):
        raise AssertionError(f"decode of the read-back file differs by "
                             f"{float(np.abs(y - y_file).max())}")
    log(f"  {len(blob)} bytes; decode of the read-back file equals the in-memory decode")
    for subset in [(p, c, r) for p in (True, False) for c in (True, False)
                   for r in (True, False) if p or c or r]:
        reset_counts()
        y = codec.decode_subset(f, *subset)
        n = counts()
        name = "".join(s for s, on in zip("pcr", subset) if on)
        log(f"  subset {name:3s}: launches resunit {n[0]} vq {n[1]}, rms "
            f"{float(np.sqrt(np.mean(y ** 2))):.4f}")
        if n != (12, 0):
            raise AssertionError(f"decode_subset {name} launched {n}, expected (12, 0)")
        if y.shape != w.shape or not np.isfinite(y).all():
            raise AssertionError(f"decode_subset {name}: wave {y.shape} is not finite")


STREAM_SECONDS = 10.0
LONG_SECONDS = 40.0
WARM_CHUNKS = 3
TRACED_CHUNKS = 10  # steady chunks of phase 7 run under torch.profiler, left out of p50 / p95


def stream_inputs(codec: FACodec) -> tuple:
    """Forward pre-hooks on every ResidualUnit of the codec that, while
    `armed["tag"]` is set, keep the (unit, x, halo) of each streamed call
    under that tag. Returns (hooks, captured, armed)."""
    captured: dict = {}
    armed = {"tag": None}

    def hook(mod, args):
        if armed["tag"] is not None and len(args) >= 3 and not args[2]:
            captured.setdefault(armed["tag"], []).append((mod, args[0], args[1]["block_1"]))

    hooks = [m.register_forward_pre_hook(hook) for part in (codec.encoder, codec.decoder)
             for m in part.modules() if isinstance(m, ResidualUnit)]
    return hooks, captured, armed


def phase_stream(codec: FACodec, B: int, chunk: int, armed: dict) -> dict:
    """One flagship streaming session over B x STREAM_SECONDS of sweep,
    checked against the card's one-shot path; the fourth steady chunk's unit
    inputs are captured under the tag (chunk, B), and TRACED_CHUNKS later
    steady chunks run under torch.profiler for the device's busy time.
    Returns its numbers."""
    w = sweep_wave(B, STREAM_SECONDS, seed=8)
    step = chunk * HOP
    wt = torch.from_numpy(w).cuda()
    timbre = torch.from_numpy(codec.timbre_of(w)).cuda()
    sess = StreamingFACodec(codec.encoder, codec.quantizer, codec.decoder,
                            chunk_frames=chunk, n_c=codec.n_c)
    log(f"phase 7: StreamingFACodec, flagship, batch {B} x {STREAM_SECONDS:.0f} s, chunk {chunk} "
        f"frames ({step / SR * 1e3:.0f} ms), prime {sess.prime_frames} frames")
    est, dst = sess.init_encode_state(B), sess.init_decode_state(B)
    waves, codes, lat, steady, traced = [], [], [], [], []
    prime_s = None
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    trace_from = WARM_CHUNKS + 2  # steady chunks before the traced ones
    torch.cuda.synchronize()
    reset_counts()
    t_run = time.perf_counter()
    for i in range(0, wt.shape[1], step):
        before = (*counts(), stream_count())
        if len(lat) == WARM_CHUNKS:
            armed["tag"] = (chunk, B)
        tracing = prime_s is not None and len(lat) + len(traced) >= trace_from and \
            len(traced) < TRACED_CHUNKS
        if tracing and not traced:
            prof.start()
        t0 = time.perf_counter()
        est, dst, y, c = sess.roundtrip_chunk(est, dst, wt[:, i : i + step], timbre)
        if y is None:
            continue
        y = y.cpu().numpy()  # the chunk's wave on the host
        dt = time.perf_counter() - t0
        armed["tag"] = None
        n = tuple(a - b for a, b in zip((*counts(), stream_count()), before))
        if prime_s is None:
            prime_s = dt
        else:
            (traced if tracing else lat).append(dt)
            steady.append(n)
            if tracing and len(traced) == TRACED_CHUNKS:
                prof.stop()
        waves.append(y)
        codes.append([x.cpu().numpy() for x in c])
    outs_t, codes_t = sess.flush_encode(est, timbre)
    dst, y = sess.decode_chunk(dst, outs_t)
    waves.append(y.cpu().numpy())
    codes.append([x.cpu().numpy() for x in codes_t])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    total = (*counts(), stream_count())
    if set(steady) != {(0, 6, 24)}:
        raise AssertionError(f"steady chunks launched (one-shot resunit, vq, halo entry) "
                             f"{sorted(set(steady))}, expected only (0, 6, 24)")
    if len(traced) != TRACED_CHUNKS:
        raise AssertionError(f"{len(traced)} traced chunks, expected {TRACED_CHUNKS}")
    n_emit = len(steady) + 1
    want_total = (0, 6 * n_emit + 6, 24 * n_emit + 12)
    if total != want_total:
        raise AssertionError(f"session launched {total}, expected {want_total}")

    recon = np.concatenate(waves, axis=1)
    stream_codes = [np.concatenate([c[j] for c in codes], axis=-1) for j in range(3)]
    f = codec.encode(w)
    one_shot = codec.reconstruct(w)
    same = sum(int((a == b).sum()) for a, b in
               zip(stream_codes, (f.codes_p, f.codes_c, f.codes_r)))
    n_codes = sum(a.size for a in stream_codes)
    diff = float(np.abs(recon - one_shot).max())
    warm = lat[WARM_CHUNKS:]
    p50, p95 = (float(np.percentile(warm, q)) for q in (50, 95))
    audio_s = B * step / SR
    log(f"  {len(lat) + 1} emitted chunks + flush in {run_s:.3f} s; priming step ({sess.prime_frames} "
        f"frames) {prime_s * 1e3:.2f} ms; steady chunk latency p50 {p50 * 1e3:.2f} ms p95 "
        f"{p95 * 1e3:.2f} ms over {len(warm)} chunks (call until its wave is on the host); "
        f"realtime factor at p50 {audio_s / p50:.1f}x ({B} x {step / SR * 1e3:.0f} ms of audio "
        f"per chunk)")
    by_kind, _, _ = traced_device_ms(prof)
    dev_ms = sum(by_kind.values()) / TRACED_CHUNKS
    wall_ms = 1e3 * sum(traced) / TRACED_CHUNKS
    log(f"  traced ({TRACED_CHUNKS} steady chunks under torch.profiler): wall {wall_ms:.2f} ms "
        f"per chunk, device kernels {dev_ms:.2f} ms per chunk ({dev_ms / wall_ms:.1%} busy): "
        + ", ".join(f"{k} {v / TRACED_CHUNKS:.2f} ms" for k, v in
                    sorted(by_kind.items(), key=lambda kv: -kv[1])))
    log(f"  launches per steady chunk: halo entry 24, vq 6, one-shot entry 0; session total "
        f"{total}; codes equal to the one-shot encode {same}/{n_codes} ({same / n_codes:.5f}); "
        f"wave max abs diff to the one-shot reconstruct {diff:.3e}")
    if recon.shape != w.shape or not np.isfinite(recon).all():
        raise AssertionError(f"streamed wave {recon.shape} is not a finite {w.shape} wave")
    if same / n_codes < CODE_MATCH_MIN:
        raise AssertionError(f"stream code match {same / n_codes} < {CODE_MATCH_MIN}")
    if not diff <= DECODE_MAX_DIFF:
        raise AssertionError(f"stream vs one-shot wave difference {diff} > {DECODE_MAX_DIFF}")
    return dict(p50_ms=p50 * 1e3, p95_ms=p95 * 1e3, prime_ms=prime_s * 1e3,
                rtf=audio_s / p50, device_ms=dev_ms, traced_wall_ms=wall_ms, halo=24, vq=6)


def stream_unit_cost(B: int, T: int, C: int, d: int) -> tuple:
    """(FLOP, bytes) of one streamed unit: as `resunit_cost`, plus the halo
    read and the new halo written."""
    flop, nbytes = resunit_cost(B, T, C)
    return flop, nbytes + 4 * 2 * B * 6 * d * C


def phase_halo(codec: FACodec, captured: dict) -> dict:
    """The halo entry against its plain version at every flagship unit."""
    log(f"phase 7a: fused_residual_unit_stream (halo entry) vs plain, max_abs_err <= "
        f"{RESUNIT_MAX_ERR}, new halo bit-equal; one call between two events (median of "
        f"{REPEATS}); bound = max(3 x FLOP at {TF32_FLOPS / 1e12:.0f} TFLOP/s, bytes at "
        f"{HBM_BYTES_S / 1e12:.2f} TB/s)")
    units = [m for part in (codec.encoder, codec.decoder) for m in part.modules()
             if isinstance(m, ResidualUnit)]
    # rows per latent frame at each unit, from the captured 16-frame chunk
    rows = {id(m): x.shape[1] // 16 for m, x, _ in captured[(16, 1)]}
    real = {(key, id(m)): (x, halo) for key, calls in captured.items() for m, x, halo in calls}
    cases = []
    for m in units:
        for chunk in (16, 4):
            for B in (1, 4):
                cases.append((m, B, chunk * rows[id(m)], real.get(((chunk, B), id(m)))))
        if m.dilation == 9:
            cases += [(m, B, T, None) for T in (1, 53, 54, 55) for B in (1, 4)]
    gen = torch.Generator(device="cuda").manual_seed(9)
    worst = 0.0
    main = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for m, B, T, x_halo in cases:
        snake1, conv7, snake2, conv1 = m.block
        C, d = conv7.bias.shape[0], m.dilation
        if x_halo is None:
            x = 0.5 * torch.randn(B, T, C, device="cuda", generator=gen)
            halo = 0.5 * torch.randn(B, 6 * d, C, device="cuda", generator=gen)
        else:
            x, halo = x_halo
        with torch.no_grad(), float32_exact():
            args = (x.contiguous(), halo, conv7.effective_weight(), conv7.bias,
                    conv1.effective_weight(), conv1.bias, snake1.alpha, snake2.alpha, d)
            before = stream_count()
            got, got_halo = resunit.fused_residual_unit_stream(*args)
            want, want_halo = resunit.residual_unit_stream_reference(*args)
            torch.cuda.synchronize()
            launched = stream_count() - before
            err = (got - want).abs().max().item()
            if not torch.equal(got_halo, want_halo):
                raise AssertionError(f"halo entry C={C} d={d} B={B} T={T}: new halo differs "
                                     f"by {(got_halo - want_halo).abs().max().item()}")
            if not err <= RESUNIT_MAX_ERR:
                raise AssertionError(f"halo entry C={C} d={d} B={B} T={T}: max_abs_err {err}")
            tk = median_ms(lambda: resunit.fused_residual_unit_stream(*args))
            tp = median_ms(lambda: resunit.residual_unit_stream_reference(*args))
        flop, nbytes = stream_unit_cost(B, T, C, d)
        b = bound_ms(3 * flop, nbytes, TF32_FLOPS)
        by = "operations" if 3 * flop / TF32_FLOPS > nbytes / HBM_BYTES_S else "bytes"
        worst = max(worst, err)
        src = "phase 7 input" if x_halo is not None else "random input"
        if x_halo is not None and (B, T) == (1, 16 * rows[id(m)]):
            for k, v in (("ms", tk), ("plain_ms", tp), ("bound_ms", b)):
                main[k] += v
        log(f"  C={C:4d} d={d} B={B} T={T:5d} ({src}): kernel {tk:.4f} ms plain {tp:.4f} ms "
            f"bound {b * 1e3:.2f} us ({by}); launches {launched}; max_abs_err {err:.3e}")
    log(f"  the 24 units of a 16-frame steady chunk at batch 1: kernel {main['ms']:.3f} ms "
        f"plain {main['plain_ms']:.3f} ms bound {main['bound_ms'] * 1e3:.2f} us")
    return dict(max_abs_err=worst, cases=len(cases), **{f"stream_{k}": v for k, v in main.items()})


def phase_encode_streaming(codec: FACodec) -> None:
    w = sweep_wave(1, LONG_SECONDS, seed=10)
    log(f"phase 7b: encode_streaming, flagship, batch 1 x {LONG_SECONDS:.0f} s, chunk 80 frames")
    reset_counts()
    t0 = time.perf_counter()
    f = codec.encode_streaming(w, chunk_frames=80)
    t_enc = time.perf_counter() - t0
    n_enc = (*counts(), stream_count())
    reset_counts()
    t0 = time.perf_counter()
    y = codec.decode_streaming(f, chunk_frames=80)
    t_dec = time.perf_counter() - t0
    n_dec = (*counts(), stream_count())
    g = codec.encode(w)
    same = sum(int((getattr(f, n) == getattr(g, n)).sum()) for n in ("codes_p", "codes_c", "codes_r"))
    n_codes = sum(getattr(f, n).size for n in ("codes_p", "codes_c", "codes_r"))
    t_diff = float(np.abs(f.timbre - codec.timbre_of(w[:, : int(10 * SR)])).max())
    y_one = codec.decode(f)
    diff = float(np.abs(y - y_one).max())
    log(f"  encode_streaming {t_enc:.3f} s (launches one-shot resunit, vq, halo entry {n_enc}), "
        f"decode_streaming {t_dec:.3f} s ({n_dec}); codes equal to the one-shot encode "
        f"{same}/{n_codes} ({same / n_codes:.5f}); timbre max diff to timbre_of(first 10 s) "
        f"{t_diff:.3e}; decode_streaming vs decode max abs {diff:.3e}")
    if n_enc[2] == 0 or n_dec[2] == 0:
        raise AssertionError("the streaming route launched no halo entry")
    if same / n_codes < CODE_MATCH_MIN:
        raise AssertionError(f"encode_streaming code match {same / n_codes} < {CODE_MATCH_MIN}")
    if not t_diff <= DECODE_MAX_DIFF:
        raise AssertionError(f"encode_streaming timbre difference {t_diff} > {DECODE_MAX_DIFF}")
    if y.shape != w.shape or not np.isfinite(y).all() or not diff <= DECODE_MAX_DIFF:
        raise AssertionError(f"decode_streaming {y.shape}, difference {diff}")


def phase_stream_vc(codec_vc: FACodec) -> None:
    fields = {k: dict(v, causal=True) for k, v in FLAGSHIP_REDECODER.items()}
    red = FARedecoder.from_fields(fields, seed=2, device="cuda")
    w = sweep_wave(1, STREAM_SECONDS, seed=11)
    codes = codec_vc.encode(w)
    timbre = codec_vc.timbre_of(sweep_wave(1, STREAM_SECONDS, seed=12))
    log(f"phase 7c: StreamingRedecoder, FLAGSHIP_REDECODER widths with causal redecoder and "
        f"decoder, batch 1 x {STREAM_SECONDS:.0f} s, chunk 16 frames")
    want = red.resynthesize(codes, timbre)
    reset_counts()
    t0 = time.perf_counter()
    got = red.resynthesize_streaming(codes, timbre, chunk_frames=16)
    dt = time.perf_counter() - t0
    n = (*counts(), stream_count())
    diff = float(np.abs(got - want).max())
    log(f"  resynthesize_streaming {dt:.3f} s, {STREAM_SECONDS / dt:.1f}x realtime; launches "
        f"(one-shot resunit, vq, halo entry) {n}; max abs difference to resynthesize {diff:.3e}")
    if n[0] or n[1] or n[2] == 0:
        raise AssertionError(f"streamed VC launched {n}")
    if got.shape != w.shape or not np.isfinite(got).all() or not diff <= DECODE_MAX_DIFF:
        raise AssertionError(f"streamed VC {got.shape}, difference {diff} > {DECODE_MAX_DIFF}")


# ------------------------------------------------------------- phase 8-9a
def phase_hybrid(codec: FACodec, codec_hy: FACodec, cpu: FACodec, w: np.ndarray) -> dict:
    """The hybrid round trip against float32 on the card, and against the
    hybrid decode on the CPU."""
    B = w.shape[0]
    log(f"phase 8: hybrid round trip (float32 encode, bfloat16_act decode), flagship, batch {B} "
        f"x {SECONDS:.0f} s")
    f32 = codec.encode(w)
    y32 = codec.decode(f32)
    codec_hy.decode(codec_hy.encode(w))  # warm the bf16 path up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    fhy = codec_hy.encode(w)
    yhy = codec_hy.decode(fhy)
    torch.cuda.synchronize()
    rt = time.perf_counter() - t0
    n = all_counts()
    log(f"  encode -> decode {rt:.3f} s; launches {n}")
    if n != dict(f32=12, bf16=12, halo=0, vq=6):
        raise AssertionError(f"hybrid round trip launched {n}, expected 12 float32 units, "
                             f"12 bf16 units, 6 VQ searches")
    for name in ("codes_p", "codes_c", "codes_r"):
        a, b = getattr(fhy, name), getattr(f32, name)
        per_row = [int((a[i] == b[i]).sum()) for i in range(B)]
        log(f"  {name}: equal to float32's {per_row} of {a[0].size} per row")
        if not np.array_equal(a, b):
            raise AssertionError(f"hybrid {name} differ from float32's")
    if not np.array_equal(fhy.timbre, f32.timbre):
        raise AssertionError("hybrid timbre differs from float32's")
    if yhy.dtype != np.float32 or yhy.shape != y32.shape or not np.isfinite(yhy).all():
        raise AssertionError(f"hybrid wave {yhy.dtype} {yhy.shape} is not a finite float32 wave")
    # against float32, the JAX package's limit (tests/test_precision.py)
    worst32, rms32 = wave_gap(yhy, y32)
    log(f"  hybrid decode vs float32 decode, same codes: err/scale {worst32:.3e} at the worst "
        f"sample (limit {HYBRID_VS_F32}), {rms32:.3e} in RMS")
    if not worst32 < HYBRID_VS_F32:
        raise AssertionError(f"hybrid vs float32 err/scale {worst32} >= {HYBRID_VS_F32}")

    # CUDA kernels one hybrid decode launches: with the units' kept packs (the
    # decode as it runs), and with each unit packing its bf16 operands on
    # every call (its pack switched off for this count only)
    kept = decode_launches(codec_hy, fhy)
    kept_pack = ResidualUnit.kept_pack
    ResidualUnit.kept_pack = lambda self, x, route: None
    try:
        per_call = decode_launches(codec_hy, fhy)
    finally:
        ResidualUnit.kept_pack = kept_pack
    log(f"  CUDA kernel launches of one hybrid decode (traced): {kept} with the units' kept "
        f"packs, {per_call} packing on every call ({(per_call - kept) / 12:.1f} a unit)")

    # times in turns: float32, hybrid, hybrid, float32
    times = {"float32": [], "hybrid": []}
    for name in ("float32", "hybrid", "hybrid", "float32"):
        c = codec if name == "float32" else codec_hy
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c.decode(c.encode(w))
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        c.reconstruct(w)
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
    log("  warm times (encode -> decode, reconstruct; in turns f32, hybrid, hybrid, f32): "
        + "; ".join(f"{k} {', '.join(f'{t:.3f}' for t in v)} s" for k, v in times.items()))

    wc = sweep_wave(1, 2.0, seed=3)
    f = codec.encode(wc)
    cpu_hy = FACodec(cpu.encoder, cpu.quantizer, cpu.decoder, precision="hybrid")
    t0 = time.perf_counter()
    y_cpu = cpu_hy.decode(f)
    y_gpu = codec_hy.decode(f)
    log(f"  card vs CPU, batch 1 x 2 s, equal codes ({time.perf_counter() - t0:.1f} s):")
    worst_cpu, rms_cpu = check_hybrid_gap("hybrid decode card vs CPU", y_gpu, y_cpu)
    return dict(hybrid_s=rt, f32_times=times["float32"], hybrid_times=times["hybrid"],
                worst32=worst32, rms32=rms32, worst_cpu=worst_cpu, rms_cpu=rms_cpu,
                launches=n, decode_kernels=kept, decode_kernels_per_call_pack=per_call, f=f32)


def decode_launches(codec_hy: FACodec, f) -> int:
    """CUDA kernels launched by one decode of f, from a traced run."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        codec_hy.decode(f)
        torch.cuda.synchronize()
    return sum(traced_device_ms(prof)[2].values())


def bf16_unit_cost(B: int, T: int, C: int) -> tuple:
    """(FLOP, bytes) of one bf16 unit: 16 C^2 FLOP per row; x read and out
    written in bf16, the float32 weights, biases and alphas read once."""
    return 16 * B * T * C * C, 2 * 2 * B * T * C + 4 * (8 * C * C + 4 * C)


def bf16_ptxas() -> dict:
    """(NW, MT, KC, SPILL) -> ptxas's spill and register lines for that
    instantiation of the bf16 kernel, from the build's log."""
    out, key = {}, None
    for line in build.build_log("resunit_bf16").splitlines():
        m = re.search(r"resunit_bf16_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb([01])E", line)
        if m:
            key = tuple(int(v) for v in m.groups())
        elif key is not None and ("spill" in line or "registers" in line):
            out.setdefault(key, []).append(line.replace("ptxas info    :", "").strip())
    return out


def phase_bf16(calls: list) -> dict:
    log(f"phase 8a: the bf16 entry (csrc/resunit_bf16.cu) vs its plain version (bfloat16_act) on "
        f"the 12 decoder units' inputs of one hybrid decode; <= {BF16_MAX_ULPS} bf16 ulps at "
        f"bf16_error_scale; kernel = one raw launch on the unit's kept pack, device time of "
        f"{GRAPH_LAUNCHES} launches in one CUDA graph / {GRAPH_LAUNCHES} (and one launch between "
        f"two events); wrapper = one fused_residual_unit call (per-call pack); unit = the "
        f"ResidualUnit call (kept pack); bound = max(FLOP at {BF16_FLOPS / 1e12:.0f} TFLOP/s, "
        f"bytes at {HBM_BYTES_S / 1e12:.2f} TB/s)")
    ptx = bf16_ptxas()
    # ms: the wrapper call (the entry's `ms` before it kept packs); kernel_ms: the kernel alone
    tot = dict(kernel_ms=0.0, events_ms=0.0, ms=0.0, unit_ms=0.0, plain_ms=0.0, flops=0,
               bound_ms=0.0)
    bound_of = {"operations": 0.0, "bytes": 0.0}
    worst_abs, worst_ulps, min_equal = 0.0, 0.0, 1.0
    seen = set()
    for unit, x in calls:
        snake1, conv7, snake2, conv1 = unit.block
        d, causal = unit.dilation, unit.causal
        with torch.no_grad(), float32_exact():
            x = x.contiguous()
            if x.dtype != torch.bfloat16:
                raise AssertionError(f"decoder unit input is {x.dtype}, expected bfloat16")
            args = (x, conv7.effective_weight(), conv7.bias, conv1.effective_weight(), conv1.bias,
                    snake1.alpha, snake2.alpha, d, causal)
            pack = unit.kept_pack(x, "bf16")  # kept by the decode that gave x
            if pack is None:
                raise AssertionError("the decoder unit keeps no packed operands")
            got = resunit.fused_residual_unit(*args)
            packed = resunit.fused_residual_unit_packed(x, pack, d, causal)
            want = resunit.residual_unit_reference(*args)
            scale = resunit.bf16_error_scale(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, packed):
                raise AssertionError("the kept pack and a per-call pack give different outputs")
            ulps = resunit.bf16_ulps(got, want, scale).max().item()
            err = (got.float() - want.float()).abs().max().item()
            equal = (got == want).float().mean().item()
            if not ulps <= BF16_MAX_ULPS:
                raise AssertionError(f"bf16 entry {tuple(x.shape)} d={d}: {ulps} ulps > "
                                     f"{BF16_MAX_ULPS}")
            B, T, C = x.shape
            pad_left, ext = resunit.reflect_extent(T, d, causal)
            out = torch.empty_like(x)

            def launch():
                resunit.launch_bf16(x, pack, d, pad_left, ext, out)
            tk = device_ms(launch)
            te = median_ms(launch)
            tw = median_ms(lambda: resunit.fused_residual_unit(*args))
            tu = median_ms(lambda: unit(x))
            tp = median_ms(lambda: resunit.residual_unit_reference(*args))
        flop, nbytes = bf16_unit_cost(B, T, C)
        b = bound_ms(flop, nbytes, BF16_FLOPS)
        by = "operations" if flop / BF16_FLOPS > nbytes / HBM_BYTES_S else "bytes"
        bound_of[by] += b
        worst_abs, worst_ulps = max(worst_abs, err), max(worst_ulps, ulps)
        min_equal = min(min_equal, equal)
        for k, v in (("kernel_ms", tk), ("events_ms", te), ("ms", tw), ("unit_ms", tu),
                     ("plain_ms", tp), ("flops", flop), ("bound_ms", b)):
            tot[k] += v
        plan = resunit.bf16_plan(B, T, C, d)
        cfg = (plan["bn"] // 2, plan["bm"] // 64, plan["kc"], plan["spill"])
        if cfg not in seen:
            seen.add(cfg)
            log(f"  kernel <NW={cfg[0]}, MT={cfg[1]}, KC={cfg[2]}, SPILL={cfg[3]}> (ptxas): "
                + "; ".join(ptx.get(cfg, ["not in the build log"])))
        log(f"  B={B} C={C:4d} T={T:6d} d={d}: FLOP {flop:.4e} bytes {nbytes} bound {b:.4f} ms "
            f"({by}); kernel {tk:.4f} ms ({b / tk:.1%} of the bound, {flop / tk / 1e9:.1f} "
            f"TFLOP/s; one launch {te:.4f} ms), wrapper {tw:.4f} ms, unit {tu:.4f} ms, plain "
            f"{tp:.4f} ms; BN {plan['bn']} x BM {plan['bm']}, KC {plan['kc']}, "
            f"{plan['stages']} stages{' (resident)' if plan['resident'] else ''}"
            f"{', s2 in the device scratch' if plan['spill'] else ''}, "
            f"{plan['smem']} B shared memory, grid {plan['grid']} "
            f"for {plan['tiles']} tiles; {equal:.4%} bit-equal, worst {ulps:.2f} ulps, max abs "
            f"{err:.3e}")
    by_all = max(bound_of, key=bound_of.get)
    log(f"  12 units: kernel {tot['kernel_ms']:.3f} ms ({tot['bound_ms'] / tot['kernel_ms']:.1%} "
        f"of the {tot['bound_ms']:.3f} ms bound, {by_all}; one launch each "
        f"{tot['events_ms']:.3f} ms), wrapper {tot['ms']:.3f} ms, unit {tot['unit_ms']:.3f} ms, "
        f"plain {tot['plain_ms']:.3f} ms; bit-equal >= {min_equal:.4%}")
    return dict(max_abs_err=worst_abs, max_ulps=worst_ulps, min_bit_equal=min_equal,
                bound_by=by_all, **tot)


def _http(method: str, url: str, data: bytes = None) -> bytes:
    resp = urllib.request.urlopen(urllib.request.Request(url, data=data, method=method),
                                  timeout=600)
    if resp.status != 200:
        raise AssertionError(f"{method} {url}: HTTP {resp.status}")
    return resp.read()


def phase_serve(codec_hy: FACodec) -> dict:
    n_req = 8
    svc = serve_cli.CodecService(codec_hy, max_batch=n_req, batch_window_ms=200.0)
    server = serve_cli.make_server(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    log(f"phase 9: serve in process ({base}), precision {codec_hy.precision}, max batch "
        f"{svc.max_batch}, batch window 200 ms; {n_req} requests of {SECONDS:.0f} s")
    try:
        blobs = [serve_cli.write_wav_bytes(w) for w in sweep_wave(n_req, SECONDS, seed=20)]
        _http("POST", f"{base}/reconstruct", blobs[0])  # warm up
        seq = []
        t0 = time.perf_counter()
        for b in blobs:
            seq.append(serve_cli.read_wav_bytes(_http("POST", f"{base}/reconstruct", b)))
        t_seq = time.perf_counter() - t0
        calls0 = svc._batcher.calls
        reset_counts()
        results = [None] * n_req
        errors = []

        def worker(i):
            try:
                results[i] = serve_cli.read_wav_bytes(_http("POST", f"{base}/reconstruct",
                                                            blobs[i]))
            except Exception as e:  # noqa: BLE001 -- reported below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_req)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        t_conc = time.perf_counter() - t0
        n = all_counts()
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"concurrent requests failed: {errors}")
        calls, seen = svc._batcher.calls - calls0, svc._batcher.max_seen
        log(f"  {n_req} concurrent /reconstruct: {calls} device call(s), largest batch {seen}, "
            f"launches {n}; {t_conc:.3f} s ({n_req / t_conc:.2f} requests/s, "
            f"{n_req * SECONDS / t_conc:.1f}x realtime); sequential {t_seq:.3f} s "
            f"({n_req / t_seq:.2f} requests/s)")
        if calls != 1 or seen != n_req:
            raise AssertionError(f"{n_req} concurrent requests ran as {calls} calls, largest "
                                 f"batch {seen}")
        if n != dict(f32=12, bf16=12, halo=0, vq=6):
            raise AssertionError(f"the batch-8 call launched {n}")
        gaps = [check_hybrid_gap(f"request {i}, batch 8 vs alone", results[i], seq[i])
                for i in range(n_req)]
        fac = _http("POST", f"{base}/encode", blobs[0])
        wav = _http("POST", f"{base}/decode", fac)
        f = FACodecFile.from_bytes(fac)
        if wav[:4] != b"RIFF" or f.codes_c.shape != (1, 2, int(SECONDS * SR / HOP)):
            raise AssertionError(f"/encode -> /decode gave {f.codes_c.shape}, {wav[:4]!r}")
        health = json.loads(_http("GET", f"{base}/health"))
        metrics = _http("GET", f"{base}/metrics").decode()
        if health["status"] != "ok" or "facodec_device_calls_total" not in metrics:
            raise AssertionError(f"/health {health}")
        log(f"  /encode -> /decode: {len(fac)} bytes of codes, {len(wav)} bytes of wav; "
            f"/health {health}")
        return dict(rps_concurrent=n_req / t_conc, rps_sequential=n_req / t_seq,
                    t_conc=t_conc, t_seq=t_seq, worst=max(g[0] for g in gaps),
                    rms=max(g[1] for g in gaps))
    finally:
        server.shutdown()
        server.server_close()
        svc.close()


def _solo_stream(sess: StreamingFACodec, wave: np.ndarray, timbre: torch.Tensor) -> np.ndarray:
    """A dedicated batch-1 session over the wave, flush included."""
    est, dst = sess.init_encode_state(1), sess.init_decode_state(1)
    w = torch.from_numpy(wave)[None].cuda()
    step = sess.chunk_frames * HOP
    parts = []
    for i in range(0, w.shape[1], step):
        est, dst, out, _ = sess.roundtrip_chunk(est, dst, w[:, i : i + step], timbre)
        if out is not None:
            parts.append(out.cpu().numpy()[0])
    outs_t, _ = sess.flush_encode(est, timbre)
    dst, out_t = sess.decode_chunk(dst, outs_t)
    parts.append(out_t.cpu().numpy()[0])
    return np.concatenate(parts)


# The live-stream clients run in a process of their own, so that their
# socket threads do not share the server's interpreter lock: N threads, each
# streaming one wave of `waves` as fast as the server answers it.
STREAM_CLIENT = r"""
import json, sys, threading, time
import numpy as np
sys.path.insert(0, sys.argv[4])
from facodec_tpu_torch.cli.stream_serve import stream_wav
port, chunk, stem = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
waves = np.load(stem + ".in.npy")
outs, errors = [None] * len(waves), []
def run(i):
    try:
        outs[i] = stream_wav("127.0.0.1", port, waves[i], chunk_frames=chunk)[0]
    except Exception as e:
        errors.append(repr(e))
threads = [threading.Thread(target=run, args=(i,)) for i in range(len(waves))]
t0 = time.perf_counter()
for t in threads:
    t.start()
for t in threads:
    t.join()
wall = time.perf_counter() - t0
if not errors:
    np.save(stem + ".out.npy", np.stack(outs))
print(json.dumps({"wall": wall, "errors": errors}))
"""


def phase_group_ticks(codec: FACodec, chunk: int, capacity: int) -> dict:
    """The group alone, no server: ticks of a group of `capacity` slots
    with 1, 4 and 8 of them active, then TRACED_CHUNKS ticks of all under
    torch.profiler."""
    from facodec_tpu_torch.models.stream_batch import BatchedStreamGroup

    sess = StreamingFACodec(codec.encoder, codec.quantizer, codec.decoder, chunk_frames=chunk,
                            n_c=codec.n_c)
    group = BatchedStreamGroup(sess, capacity)
    P, step, n_ticks = sess.prime_frames, chunk * HOP, 60
    w = sweep_wave(capacity, (P * HOP + (3 * n_ticks + TRACED_CHUNKS) * step) / SR, seed=40)
    timbre = torch.from_numpy(codec.timbre_of(w[:, : P * HOP])).cuda()
    slots = [group.join(torch.from_numpy(w[i : i + 1, : P * HOP]).cuda(), timbre[i : i + 1])[0]
             for i in range(capacity)]
    log(f"phase 9a: BatchedStreamGroup alone (capacity {capacity}, {chunk}-frame chunks): "
        f"{n_ticks} ticks each with 1, 4 and 8 active slots (the call until the outputs are on "
        f"the host; first 10 left out)")
    out = {}
    pos = P * HOP
    for n in (1, 4, 8):
        times = []
        for i in range(n_ticks):
            chunks = {s: w[s, pos : pos + step] for s in slots[:n]}
            pos += step
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            group.tick(chunks)
            times.append(time.perf_counter() - t0)
        t = np.array(times[10:]) * 1e3
        out[n] = dict(p50_ms=float(np.percentile(t, 50)), p95_ms=float(np.percentile(t, 95)))
        log(f"  {n} active slot(s): tick p50 {out[n]['p50_ms']:.2f} ms p95 "
            f"{out[n]['p95_ms']:.2f} ms")
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with prof:
        for i in range(TRACED_CHUNKS):
            group.tick({s: w[s, pos + i * step : pos + (i + 1) * step] for s in slots})
    wall_ms = (time.perf_counter() - t0) * 1e3 / TRACED_CHUNKS
    by_kind, _, _ = traced_device_ms(prof)
    dev_ms = sum(by_kind.values()) / TRACED_CHUNKS
    log(f"  traced, 8 slots: wall {wall_ms:.2f} ms per tick, device kernels {dev_ms:.2f} ms "
        f"({dev_ms / wall_ms:.1%} busy): " + ", ".join(
            f"{k} {v / TRACED_CHUNKS:.2f} ms" for k, v in
            sorted(by_kind.items(), key=lambda kv: -kv[1])))
    out["traced"] = dict(wall_ms=wall_ms, device_ms=dev_ms)
    return out


LIVE_SECONDS = 2.0  # each live stream's length, and each solo session's it is held to
LIVE_STREAMS = (1, 8)  # concurrent connections a run (4 was cut for time)


def phase_live(codec_hy: FACodec) -> dict:
    import os
    import tempfile

    chunk, capacity = 4, 8
    group_alone = phase_group_ticks(codec_hy, chunk, capacity)
    svc = serve_cli.CodecService(codec_hy)
    streaming = stream_serve.StreamingService(svc, group_capacity=capacity)
    server = stream_serve.make_stream_server(streaming, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    disp = streaming.dispatcher(chunk)
    tick_counts = []
    group_tick = disp.group.tick

    def counted_tick(chunks, **kw):  # runs under the service lock
        before = all_counts()
        out = group_tick(chunks, **kw)
        tick_counts.append({k: v - before[k] for k, v in all_counts().items()})
        return out

    disp.group.tick = counted_tick
    chunk_ms = chunk * HOP / SR * 1e3
    log(f"phase 9a: live streams through StreamingService (group capacity {capacity}, window "
        f"{disp.window_s * 1e3:.0f} ms) on tcp://127.0.0.1:{port}, {chunk}-frame "
        f"({chunk_ms:.0f} ms) chunks, {LIVE_SECONDS:.0f} s per stream, clients in a separate "
        f"process")
    sess = streaming.session(chunk)
    root = os.path.dirname(os.path.abspath(__file__))
    out = {"group_alone": group_alone}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            def run_clients(waves, stem):
                np.save(os.path.join(tmp, stem + ".in.npy"), waves)
                res = subprocess.run([sys.executable, "-c", STREAM_CLIENT, str(port), str(chunk),
                                      os.path.join(tmp, stem), root],
                                     capture_output=True, text=True, timeout=900)
                if res.returncode != 0:
                    raise AssertionError(f"stream clients failed: {res.stderr[-2000:]}")
                info = json.loads(res.stdout.strip().splitlines()[-1])
                if info["errors"]:
                    raise AssertionError(f"stream clients failed: {info['errors']}")
                return np.load(os.path.join(tmp, stem + ".out.npy")), info["wall"]

            run_clients(sweep_wave(1, 1.0, seed=29), "warm")
            for n in LIVE_STREAMS:
                waves = sweep_wave(n, LIVE_SECONDS, seed=30 + n)
                disp.tick_s.clear()
                tick_counts.clear()
                results, wall = run_clients(waves, f"s{n}")
                ticks = list(disp.tick_s)
                dts = np.array([dt for dt, _ in ticks]) * 1e3
                stacked = np.array([k for _, k in ticks])
                p50, p95 = (float(np.percentile(dts, q)) for q in (50, 95))
                bad = [c for c in tick_counts if c != dict(f32=0, bf16=0, halo=24, vq=6)]
                if bad:
                    raise AssertionError(f"ticks launched {bad[:3]}, expected 24 halo entries "
                                         f"and 6 VQ searches each")
                worst = 0.0
                for i in range(n):
                    timbre = torch.from_numpy(streaming.timbre_from_wave(
                        waves[i][: sess.prime_frames * HOP])).cuda()
                    want = _solo_stream(sess, waves[i], timbre)
                    if results[i].shape != want.shape:
                        raise AssertionError(f"stream {i}: {results[i].shape} vs {want.shape}")
                    worst = max(worst, float(np.abs(results[i] - want).max()))
                # each client sends as fast as it is answered: one stream's
                # time per chunk is the wall over its chunks
                period = wall / (waves.shape[1] // (chunk * HOP)) * 1e3
                log(f"  {n} stream(s): a stream's chunk every {period:.2f} ms "
                    f"({'faster' if period < chunk_ms else 'slower'} than real time); "
                    f"{len(ticks)} ticks, slots per tick mean {stacked.mean():.2f} max "
                    f"{stacked.max()}; tick p50 {p50:.2f} ms p95 {p95:.2f} ms "
                    f"({'under' if p95 < chunk_ms else 'over'} the {chunk_ms:.0f} ms chunk at "
                    f"p95); every tick 24 halo / 6 VQ; max abs vs solo sessions {worst:.3e}")
                if not worst <= DECODE_MAX_DIFF:
                    raise AssertionError(f"grouped streams vs solo: {worst} > {DECODE_MAX_DIFF}")
                out[n] = dict(p50_ms=p50, p95_ms=p95, period_ms=period, ticks=len(ticks),
                              mean_slots=float(stacked.mean()), max_abs=worst)
    finally:
        server.shutdown()
        server.server_close()
        streaming.close()
        svc.close()
    return out

# ------------------------------------------------------------- phase 10
TRAIN_BATCH, TRAIN_FRAMES = 4, 80  # the JAX loop's batch and segment
TRAIN_GRAD_TOL = 1e-4  # a kernel path's gradients against plain autograd's, of max|g|
VQ_GRAD_TOL = 1e-6  # the codebook gradient against the plain gather's, of max|g|
STEP_TOL = 1e-3  # a step's losses and gradient norms, card against CPU, relative
TRAIN_STEPS = 4  # one warm-up step, three timed
UNIT_GRADS = ("x", "w7", "b7", "w1", "b1", "alpha1", "alpha2")


def np_train_batch(B: int, frames: int, seed: int, max_s: float = 30.0) -> dict:
    """A training batch as the loop makes it, in numpy: PseudoDataset
    utterances of 1..max_s s, collated into 80-frame buckets, one crop of
    `frames` each."""
    ds = PseudoDataset(length=B, seed=seed, max_s=max_s)
    return segment_batch(collate([ds[i] for i in range(B)], bucket_frames=80),
                         max_frames=frames, generator=torch.Generator().manual_seed(seed))


def train_batch(B: int, frames: int, seed: int, device: str, max_s: float = 30.0) -> dict:
    """`np_train_batch` on `device`."""
    return to_device(np_train_batch(B, frames, seed, max_s), device)


def draws_off(models: dict) -> dict:
    """Every draw of the generator forward out of play (the step's CPU and
    card legs then see the same numbers): no quantizer dropout, the residual
    stream always kept, every dropout rate 0."""
    for m in models["quantizer"].modules():
        if isinstance(m, ResidualVectorQuantize):
            m.quantizer_dropout = 0.0
        for attr in ("p_dropout", "dropout"):
            if isinstance(getattr(m, attr, None), float):
                setattr(m, attr, 0.0)
    models["quantizer"].prob_random_mask_residual = 0.0
    return models


def unit_grad_checks(units: list, gen: torch.Generator) -> tuple:
    """Each captured unit input through the kernel's custom op and
    the plain composition's autograd: forward within phase 2a's limit, the
    gradients of x, both weights, both biases and both alphas within
    TRAIN_GRAD_TOL x max|g|; forward and forward+backward times.
    Returns (worst forward error, worst gradient gap, summed times)."""
    worst_fwd = worst_grad = 0.0
    tot = dict(fwd_ms=0.0, fwd_plain_ms=0.0, fwd_bwd_ms=0.0, fwd_bwd_plain_ms=0.0, fwd_flops=0,
               fwd_bound_fp32_ms=0.0, fwd_bound_ms=0.0)
    for unit, x in units:
        snake1, conv7, snake2, conv1 = unit.block
        base = [t.detach().contiguous() for t in (
            x, conv7.effective_weight(), conv7.bias, conv1.effective_weight(), conv1.bias,
            snake1.alpha, snake2.alpha)]
        cot = torch.randn(x.shape, device="cuda", generator=gen)

        def run(fn, backward=True):
            leaves = [t.clone().requires_grad_(backward) for t in base]
            y = fn(*leaves, unit.dilation, unit.causal)
            return y, (torch.autograd.grad(y, leaves, cot) if backward else None)

        with float32_exact():
            got, g_kernel = run(resunit.fused_residual_unit)
            want, g_plain = run(resunit.residual_unit_reference)
            err = (got - want).abs().max().item()
            torch.testing.assert_close(got, want, rtol=RESUNIT_TOL, atol=RESUNIT_TOL)
            if not err <= RESUNIT_MAX_ERR:
                raise AssertionError(f"max_abs_err {err} > {RESUNIT_MAX_ERR}")
            rel = {}
            for name, a, b in zip(UNIT_GRADS, g_kernel, g_plain):
                rel[name] = ((a - b).abs().max() / b.abs().max()).item()
                if not rel[name] <= TRAIN_GRAD_TOL:
                    raise AssertionError(f"unit C={x.shape[-1]} d={unit.dilation}: {name} "
                                         f"gradient {rel[name]:.3e} of max|g| off plain")
            with torch.no_grad():
                tk = median_ms(lambda: resunit.fused_residual_unit(*base, unit.dilation,
                                                                   unit.causal))
                tp = median_ms(lambda: resunit.residual_unit_reference(*base, unit.dilation,
                                                                       unit.causal))
            tkb = median_ms(lambda: run(resunit.fused_residual_unit))
            tpb = median_ms(lambda: run(resunit.residual_unit_reference))
        worst_fwd, worst_grad = max(worst_fwd, err), max(worst_grad, max(rel.values()))
        B, T, C = x.shape
        flop, nbytes = resunit_cost(B, T, C)
        for k, v in (("fwd_ms", tk), ("fwd_plain_ms", tp), ("fwd_bwd_ms", tkb),
                     ("fwd_bwd_plain_ms", tpb), ("fwd_flops", flop),
                     ("fwd_bound_fp32_ms", bound_ms(flop, nbytes, FP32_FLOPS)),
                     ("fwd_bound_ms", bound_ms(3 * flop, nbytes, TF32_FLOPS))):
            tot[k] += v
        log(f"  B={B} C={C:4d} T={T:6d} d={unit.dilation}: forward max_abs_err {err:.3e}, "
            f"gradients (of max|g|) " + " ".join(f"{k} {v:.1e}" for k, v in rel.items())
            + f"; forward kernel {tk:.3f} ms plain {tp:.3f} ms, forward+backward kernel "
            f"{tkb:.3f} ms plain {tpb:.3f} ms")
    log(f"  {len(units)} units: forward kernel {tot['fwd_ms']:.3f} ms plain "
        f"{tot['fwd_plain_ms']:.3f} ms; forward+backward kernel {tot['fwd_bwd_ms']:.3f} ms plain "
        f"{tot['fwd_bwd_plain_ms']:.3f} ms (the backward recomputes the plain composition); "
        f"forward FLOP {tot['fwd_flops']:.4e}, bound {tot['fwd_bound_fp32_ms']:.3f} ms fp32 / "
        f"{tot['fwd_bound_ms']:.3f} ms 3xtf32")
    return worst_fwd, worst_grad, tot


def phase_train_kernels(models: dict, batch: dict) -> dict:
    """10a: both kernels with their gradients, on the inputs of one
    training forward."""
    log(f"phase 10a: kernel gradients on the card, on the inputs of one flagship training "
        f"forward (batch {TRAIN_BATCH} x {TRAIN_FRAMES} frames): forward to phase 2a's limit, "
        f"gradients of {', '.join(UNIT_GRADS)} within {TRAIN_GRAD_TOL} x max|g| of plain "
        f"autograd; VQ codebook gradient within {VQ_GRAD_TOL} x max|g| of the plain gather's, "
        f"latent gradient zero")
    units, searches = [], []
    hooks = [m.register_forward_pre_hook(lambda mod, args: units.append((mod, args[0])))
             for part in (models["encoder"], models["decoder"]) for m in part.modules()
             if isinstance(m, ResidualUnit)]
    hooks += [vqm.in_proj.register_forward_hook(
        lambda mod, args, out, vqm=vqm: searches.append((vqm, out)))
        for vqm in models["quantizer"].modules() if isinstance(vqm, VectorQuantize)]
    with float32_exact():
        out = gen_forward(models, batch, torch.Generator(device="cuda").manual_seed(1))
    for h in hooks:
        h.remove()
    del out
    if (len(units), len(searches)) != (24, 6):
        raise AssertionError(f"{len(units)} units and {len(searches)} searches, expected 24, 6")
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst_fwd, worst_grad, tot = unit_grad_checks(units, gen)
    worst_vq = 0.0
    for i, (vqm, z_e) in enumerate(searches):
        lat = z_e.detach().reshape(-1, z_e.shape[-1]).contiguous()
        cb = vqm.codebook.weight.detach()
        idx, _, _ = _vq_check(lat, cb, f"training search {i}")
        lat_k, cb_k, cb_p = (t.clone().requires_grad_(True) for t in (lat, cb, cb))
        _, zq = vq.nearest_code(lat_k, cb_k)
        cot = torch.randn(zq.shape, device="cuda", generator=gen)
        g_lat, g_cb = torch.autograd.grad(zq, (lat_k, cb_k), cot)
        (g_plain,) = torch.autograd.grad(cb_p[idx.long()], cb_p, cot)
        rel = ((g_cb - g_plain).abs().max() / g_plain.abs().max()).item()
        if not rel <= VQ_GRAD_TOL or g_lat.abs().max().item() != 0.0:
            raise AssertionError(f"VQ search {i}: codebook gradient {rel:.3e} of max|g| off the "
                                 f"gather's, latent gradient max {g_lat.abs().max().item()}")
        worst_vq = max(worst_vq, rel)
        log(f"  search {i}: codebook gradient {rel:.2e} of max|g| off the plain gather's, "
            f"latent gradient 0")
    return dict(max_abs_err=worst_fwd, grad_max_rel=worst_grad, vq_grad_max_rel=worst_vq, **tot)


def phase_train_cpu() -> dict:
    """10b: one draws-off step of the flagship at batch 1 x 20 frames, on the
    CPU (plain versions) and on the card (kernels), from one seed; then 19b:
    the same step under each bf16 policy, from the same seeded state."""
    log(f"phase 10b: one training step, card against CPU, FLAGSHIP_TRAIN seed 7, batch 1 x 20 "
        f"frames, draws off; losses and gradient norms within {STEP_TOL} relative")
    models, start = {}, {}
    for device in ("cpu", "cuda"):
        t0 = time.perf_counter()
        models[device] = draws_off(build_models(FLAGSHIP_TRAIN, 7, device))
        start[device] = {k: {n: t.clone() for n, t in m.state_dict().items()}
                         for k, m in models[device].items()}
        log(f"  {device}: built in {time.perf_counter() - t0:.1f} s")
    out = {}
    for precision in ("float32", *BF16_TRAIN):
        if precision != "float32":
            log(f"phase 19b: the same step under {precision}, card against CPU; losses within "
                f"{BF16_STEP_TOL} relative (two faithful bf16 evaluations sum in other orders "
                f"and round apart; the CPU tests hold the port to the JAX step by the same "
                f"limit), gradient norms printed")
        got = {}
        for device in ("cpu", "cuda"):
            for k, m in models[device].items():
                m.load_state_dict(start[device][k])
            step = make_codec_train_step(models[device], build_optimizers(models[device]),
                                         precision=precision)
            batch = train_batch(1, 20, 3, device, max_s=2.0)
            t0 = time.perf_counter()
            got[device] = {k: float(v) for k, v in step(batch, None)[0].items()}
            log(f"  {precision} {device}: step in {time.perf_counter() - t0:.1f} s")
        worst = 0.0
        for k in sorted(got["cpu"]):
            a, b = got["cuda"][k], got["cpu"][k]
            rel = abs(a - b) / max(abs(b), 1e-12)
            log(f"  {precision} {k}: card {a:.6g} cpu {b:.6g} (rel {rel:.2e})")
            if not np.isfinite(a):
                raise AssertionError(f"{precision} {k}: card {a}")
            if precision == "float32" or k.startswith("loss/"):
                worst = max(worst, rel)
                if not rel <= (STEP_TOL if precision == "float32" else BF16_STEP_TOL):
                    raise AssertionError(f"{precision} {k}: card {a} against CPU {b}")
        out[precision] = worst
    del models, start
    torch.cuda.empty_cache()
    return dict(step_max_rel=out.pop("float32"), bf16_step_max_rel=out)


def phase_train(smi: str) -> dict:
    """10c: run_training at full width; then a resume; then one traced step."""
    log(f"phase 10c: run_training(fields=FLAGSHIP_TRAIN, device='cuda'), PseudoDataset, batch "
        f"{TRAIN_BATCH} x {TRAIN_FRAMES} frames, {TRAIN_STEPS} steps (1 warm-up), a checkpoint "
        f"at step {TRAIN_STEPS}, then a resume to step {TRAIN_STEPS + 1} [{smi}]")
    log_dir = tempfile.mkdtemp(prefix="train_smoke_", dir=build.BUILD_DIR)
    try:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = run_training(fields=FLAGSHIP_TRAIN, device="cuda", max_steps=TRAIN_STEPS,
                             log_dir=log_dir, log_writer=False, log_interval=1,
                             save_interval=TRAIN_STEPS)
        wall = time.perf_counter() - t0
        c = all_counts()
        per_step = dict(f32=c["f32"] / TRAIN_STEPS, vq=c["vq"] / TRAIN_STEPS)
        if (c["f32"], c["vq"], c["bf16"], c["halo"]) != (24 * TRAIN_STEPS, 6 * TRAIN_STEPS, 0, 0):
            raise AssertionError(f"launches {c} over {TRAIN_STEPS} steps; expected 24 residual "
                                 f"units and 6 VQ searches a step")
        times = [1e3 * state.step_times[s] for s in range(2, TRAIN_STEPS + 1)]
        step_ms = statistics.median(times)
        peak = torch.cuda.max_memory_allocated()
        audio_s = TRAIN_BATCH * TRAIN_FRAMES * HOP / SR
        for k, v in sorted(state.metrics.items()):
            log(f"  {k} {v:.6g}")
            if not np.isfinite(v):
                raise AssertionError(f"{k} is not finite: {v}")
        init = build_models(FLAGSHIP_TRAIN, 0, "cpu")
        for name, m in state.models.items():
            moved = sum(not torch.equal(p.detach().cpu(), q) for p, q in
                        zip(m.parameters(), init[name].parameters()))
            n = len(list(m.parameters()))
            log(f"  {name}: {moved} of {n} parameter tensors changed")
            if moved == 0:
                raise AssertionError(f"{name}: no parameter changed")
        del init
        log(f"  step ms (host clock, a step until its metrics are read): first "
            f"{1e3 * state.step_times[1]:.1f}, then " + ", ".join(f"{t:.1f}" for t in times)
            + f"; median {step_ms:.1f} ms, {1e3 / step_ms:.2f} steps/s, "
            f"{audio_s * 1e3 / step_ms:.2f} s of audio per s; peak memory "
            f"{peak / 2**30:.2f} GiB; launches per step {per_step}; run_training {wall:.1f} s "
            f"[{smi}]")
        ckpt = latest_checkpoint(log_dir)
        if not ckpt.endswith(f"_step_{TRAIN_STEPS:05d}.pth"):
            raise AssertionError(f"latest checkpoint {ckpt}")
        del state
        torch.cuda.empty_cache()
        reset_counts()
        state = run_training(fields=FLAGSHIP_TRAIN, device="cuda", max_steps=TRAIN_STEPS + 1,
                             log_dir=log_dir, log_writer=False, log_interval=1,
                             save_interval=10**9)
        c = all_counts()
        if state.step != TRAIN_STEPS + 1 or state.optimizers["encoder"].count != TRAIN_STEPS + 1:
            raise AssertionError(f"resume reached step {state.step}")
        if (c["f32"], c["vq"]) != (24, 6):
            raise AssertionError(f"resumed step launched {c}")
        log(f"  resumed from {os.path.basename(ckpt)} to step {state.step}: launches {c}")

        step_fn = make_codec_train_step(state.models, state.optimizers)
        batch = train_batch(TRAIN_BATCH, TRAIN_FRAMES, 11, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(5)
        step_fn(batch, gen)
        prof = train_profile(step_fn, batch, gen)
        log("  steady step, device ms per part (CUDA events at the step's phase marks): "
            + ", ".join(f"{k} {v:.2f}" for k, v in prof["phases"].items()))
        print_breakdown(prof["by_kind"], prof["by_name"], prof["count"], prof["traced_wall_ms"])
        kernel_ms = {kind: prof["by_kind"].get(kind, 0.0)
                     for kind in (RESUNIT_F32, PROFILE_VQ)}
        del state, step_fn
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    return dict(step_ms=step_ms, steps_s=1e3 / step_ms, audio_s_per_s=audio_s * 1e3 / step_ms,
                peak_bytes=peak, per_step=per_step, times=times, phases=prof["phases"],
                kernel_ms=kernel_ms)


# ------------------------------------------------------------- phase 11
RED_STEPS = 4  # one warm-up step, three timed
VARIANT_TOL = 1e-4  # a split or remat step's metrics against the fused step's, relative
VARIANT_STEPS = 2  # timed steps of each variant after its warm-up


def red_setup(device: str, seed: int = 0) -> tuple:
    """(frozen codec, the three trained modules) of FLAGSHIP_REDECODER_TRAIN."""
    codec = build_frozen_codec(FLAGSHIP_REDECODER_TRAIN["codec"], device)
    return codec, build_redecoder_models(FLAGSHIP_REDECODER_TRAIN, seed, device)


def red_batch(B: int, frames: int, seed: int, device: str, max_s: float = 30.0) -> dict:
    """A redecoder batch as its loop makes it: the crop, the full waves and
    their lengths of `train_batch`."""
    batch = train_batch(B, frames, seed, device, max_s)
    return {k: batch[k] for k in ("wave_seg", "full_waves", "wave_lens")}


def phase_red_kernels(codec: dict, models: dict, batch: dict) -> dict:
    """11a: the residual unit's Function on the 12 non-causal decoder units
    of one redecoder-training forward."""
    log(f"phase 11a: kernel gradients on the card, on the 12 non-causal decoder units of one "
        f"redecoder-training forward (FLAGSHIP_REDECODER_TRAIN, batch {TRAIN_BATCH} x "
        f"{TRAIN_FRAMES} frames): forward to phase 2a's limit, gradients of "
        f"{', '.join(UNIT_GRADS)} within {TRAIN_GRAD_TOL} x max|g| of plain autograd")
    with float32_exact():
        codes, timbre = frozen_encode(codec, batch)
        units = unit_inputs((models["decoder"],), lambda: redecoder_forward(
            models, codes, timbre, torch.Generator(device="cuda").manual_seed(1)), 12)
    if any(unit.causal for unit, _ in units):
        raise AssertionError("the redecoder's decoder units should be non-causal")
    worst_fwd, worst_grad, tot = unit_grad_checks(units, torch.Generator(device="cuda")
                                                  .manual_seed(2))
    return dict(max_abs_err=worst_fwd, grad_max_rel=worst_grad, **tot)


def phase_red_cpu() -> dict:
    """11b: one draws-off redecoder step at batch 1 x 20 frames, on the CPU
    (plain versions) and on the card (kernels), from one seed."""
    log(f"phase 11b: one redecoder step, card against CPU, FLAGSHIP_REDECODER_TRAIN seed 7, "
        f"batch 1 x 20 frames, draws off; losses and gradient norms within {STEP_TOL} relative")
    out = {}
    for device in ("cpu", "cuda"):
        t0 = time.perf_counter()
        codec, models = red_setup(device, seed=7)
        models["encoder"].encoder.p_dropout = 0.0
        step = make_redecoder_train_step(codec, models, build_optimizers(models))
        batch = red_batch(1, 20, 3, device, max_s=2.0)
        t1 = time.perf_counter()
        out[device] = {k: float(v) for k, v in step(batch, None)[0].items()}
        log(f"  {device}: built in {t1 - t0:.1f} s, step in {time.perf_counter() - t1:.1f} s")
        del codec, models, step
    worst = 0.0
    for k in sorted(out["cpu"]):
        a, b = out["cuda"][k], out["cpu"][k]
        rel = abs(a - b) / max(abs(b), 1e-12)
        worst = max(worst, rel)
        log(f"  {k}: card {a:.6g} cpu {b:.6g} (rel {rel:.2e})")
        if not (np.isfinite(a) and rel <= STEP_TOL):
            raise AssertionError(f"{k}: card {a} against CPU {b}")
    return dict(step_max_rel=worst)


def phase_red_train(smi: str) -> dict:
    """11c: run_redecoder_training at full width; a resume; one traced step."""
    log(f"phase 11c: run_redecoder_training(fields=FLAGSHIP_REDECODER_TRAIN, device='cuda'), "
        f"PseudoDataset, batch {TRAIN_BATCH} x {TRAIN_FRAMES} frames, {RED_STEPS} steps "
        f"(1 warm-up), a checkpoint at step {RED_STEPS}, then a resume to step "
        f"{RED_STEPS + 1} [{smi}]")
    log_dir = tempfile.mkdtemp(prefix="red_smoke_", dir=build.BUILD_DIR)
    try:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = run_redecoder_training(fields=FLAGSHIP_REDECODER_TRAIN, device="cuda",
                                       max_steps=RED_STEPS, log_dir=log_dir, log_writer=False,
                                       log_interval=1, save_interval=RED_STEPS)
        wall = time.perf_counter() - t0
        c = all_counts()
        per_step = dict(f32=c["f32"] / RED_STEPS, vq=c["vq"] / RED_STEPS)
        if (c["f32"], c["vq"], c["bf16"], c["halo"]) != (24 * RED_STEPS, 6 * RED_STEPS, 0, 0):
            raise AssertionError(f"launches {c} over {RED_STEPS} steps; expected 24 residual "
                                 f"units (12 frozen encoder, 12 decoder) and 6 VQ searches a step")
        times = [1e3 * state.step_times[s] for s in range(2, RED_STEPS + 1)]
        step_ms = statistics.median(times)
        peak = torch.cuda.max_memory_allocated()
        audio_s = TRAIN_BATCH * TRAIN_FRAMES * HOP / SR
        for k, v in sorted(state.metrics.items()):
            log(f"  {k} {v:.6g}")
            if not np.isfinite(v):
                raise AssertionError(f"{k} is not finite: {v}")
        init_codec, init = red_setup("cpu")
        for name, m in state.models.items():
            moved = sum(not torch.equal(p.detach().cpu(), q) for p, q in
                        zip(m.parameters(), init[name].parameters()))
            log(f"  {name}: {moved} of {len(list(m.parameters()))} parameter tensors changed")
            if moved == 0:
                raise AssertionError(f"{name}: no parameter changed")
        for name, m in state.frozen.items():
            want = init_codec[name].state_dict()
            for key, t in m.state_dict().items():
                if not torch.equal(t.cpu(), want[key]):
                    raise AssertionError(f"frozen {name}.{key} changed")
        log("  frozen encoder and quantizer: every tensor bit-equal to the seeded codec")
        del init, init_codec
        log(f"  step ms (host clock, a step until its metrics are read): first "
            f"{1e3 * state.step_times[1]:.1f}, then " + ", ".join(f"{t:.1f}" for t in times)
            + f"; median {step_ms:.1f} ms, {1e3 / step_ms:.2f} steps/s, "
            f"{audio_s * 1e3 / step_ms:.2f} s of audio per s; peak memory "
            f"{peak / 2**30:.2f} GiB; launches per step {per_step}; run {wall:.1f} s [{smi}]")
        ckpt = latest_checkpoint(log_dir)
        if not ckpt.endswith(f"_step_{RED_STEPS:05d}.pth"):
            raise AssertionError(f"latest checkpoint {ckpt}")
        del state
        torch.cuda.empty_cache()
        reset_counts()
        state = run_redecoder_training(fields=FLAGSHIP_REDECODER_TRAIN, device="cuda",
                                       max_steps=RED_STEPS + 1, log_dir=log_dir,
                                       log_writer=False, log_interval=1, save_interval=10**9)
        c = all_counts()
        if state.step != RED_STEPS + 1 or state.optimizers["decoder"].count != RED_STEPS + 1:
            raise AssertionError(f"resume reached step {state.step}")
        if (c["f32"], c["vq"]) != (24, 6):
            raise AssertionError(f"resumed step launched {c}")
        log(f"  resumed from {os.path.basename(ckpt)} to step {state.step}: launches {c}")

        step_fn = make_redecoder_train_step(state.frozen, state.models, state.optimizers)
        batch = red_batch(TRAIN_BATCH, TRAIN_FRAMES, 11, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(5)
        step_fn(batch, gen)
        prof = train_profile(step_fn, batch, gen)
        log("  steady step, device ms per part (CUDA events at the step's phase marks): "
            + ", ".join(f"{k} {v:.2f}" for k, v in prof["phases"].items()))
        print_breakdown(prof["by_kind"], prof["by_name"], prof["count"], prof["traced_wall_ms"])
        kernel_ms = {kind: prof["by_kind"].get(kind, 0.0)
                     for kind in (RESUNIT_F32, PROFILE_VQ)}
        del state, step_fn
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    return dict(step_ms=step_ms, steps_s=1e3 / step_ms, audio_s_per_s=audio_s * 1e3 / step_ms,
                peak_bytes=peak, per_step=per_step, times=times, phases=prof["phases"],
                kernel_ms=kernel_ms, device_ms=sum(prof["by_kind"].values()),
                traced_wall_ms=prof["traced_wall_ms"])


def variant_runs(label: str, states: dict, make, expected: dict) -> dict:
    """One step of each variant from the same module states (`make(states)`
    restores them and gives the step factory's arguments) and generator
    seed, after a warm-up step from the same: metrics against the fused
    step's, peak memory above the states, launches (residual units, VQ
    searches) against `expected`; then the median host time, until the
    metrics are read, of that step and the next VARIANT_STEPS - 1."""
    out = {}
    for variant, (factory, remat, want) in expected.items():
        for _ in range(2):  # a warm-up step, then the measured one
            step = factory(*make(states), remat=remat)
            gen = torch.Generator(device="cuda").manual_seed(9)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            reset_counts()
            t0 = time.perf_counter()
            metrics = {k: float(v) for k, v in step(states["batch"], gen)[0].items()}
            times = [1e3 * (time.perf_counter() - t0)]
        c = all_counts()
        peak = torch.cuda.max_memory_allocated() - base
        if (c["f32"], c["vq"]) != want:
            raise AssertionError(f"{label} {variant}: launches {c}, expected {want}")
        for _ in range(VARIANT_STEPS - 1):  # steps on from there, for the time
            t0 = time.perf_counter()
            float(step(states["batch"], gen)[0]["loss/gen_all"])
            times.append(1e3 * (time.perf_counter() - t0))
        del step
        out[variant] = dict(metrics=metrics, peak_bytes=peak, launches=(c["f32"], c["vq"]),
                            ms=statistics.median(times), times=times)
    fused = out["fused"]["metrics"]
    for variant, r in out.items():
        worst = max(abs(r["metrics"][k] - v) / max(abs(v), 1e-12) for k, v in fused.items())
        r["max_rel"] = worst
        log(f"  {label} {variant}: peak {r['peak_bytes'] / 2**30:.2f} GiB above the states, "
            f"launches {r['launches']}, step ms " + ", ".join(f"{t:.1f}" for t in r["times"])
            + f" (median {r['ms']:.1f}), metrics within {worst:.2e} of fused "
            f"(limit {VARIANT_TOL})")
        if not worst <= VARIANT_TOL:
            raise AssertionError(f"{label} {variant}: metrics {worst} off the fused step")
    return out


def phase_variants() -> dict:
    """11d: fused, split and remat steps of the redecoder and the codec."""
    log(f"phase 11d: one step each of fused, split and remat from one state and one generator "
        f"seed, dropout on, batch {TRAIN_BATCH} x {TRAIN_FRAMES} frames: metrics within "
        f"{VARIANT_TOL} relative of fused, peak memory, launches")
    codec, models = red_setup("cuda")
    red_states = dict(codec=codec, init={k: {n: t.clone() for n, t in m.state_dict().items()}
                                         for k, m in models.items()},
                      models=models, batch=red_batch(TRAIN_BATCH, TRAIN_FRAMES, 13, "cuda"))

    def make_red(st):
        for k, m in st["models"].items():
            m.load_state_dict(st["init"][k])
        return st["codec"], st["models"], build_optimizers(st["models"])

    red = variant_runs("redecoder", red_states, make_red, {
        "fused": (make_redecoder_train_step, False, (24, 6)),
        "split": (make_redecoder_train_step_split, False, (36, 6)),
        "remat": (make_redecoder_train_step, True, (36, 6))})
    del red_states, codec, models
    torch.cuda.empty_cache()

    models = build_models(FLAGSHIP_TRAIN, 0, "cuda")
    codec_states = dict(init={k: {n: t.clone() for n, t in m.state_dict().items()}
                              for k, m in models.items()},
                        models=models, batch=train_batch(TRAIN_BATCH, TRAIN_FRAMES, 13, "cuda"))

    def make_codec(st):
        for k, m in st["models"].items():
            m.load_state_dict(st["init"][k])
        return st["models"], build_optimizers(st["models"])

    cod = variant_runs("codec", codec_states, make_codec, {
        "fused": (make_codec_train_step, False, (24, 6)),
        "split": (make_codec_train_step_split, False, (48, 12)),
        "remat": (make_codec_train_step, True, (48, 12))})
    del codec_states, models
    torch.cuda.empty_cache()
    return dict(redecoder=red, codec=cod)


# ------------------------------------------------------------- phase 12
# 12a's data: 8 int16 24 kHz utterances of 1-12 s, one 8-bit 16 kHz and one
# float64 stereo 44.1 kHz file; 2 of the 10 go to val.txt.
OWN_SECONDS = (1.0, 2.5, 4.0, 5.5, 7.0, 8.5, 10.0, 12.0)
TEACHER_TOL = 1e-3  # the teacher's F0, card against CPU, of max|F0|
OWN_STEPS = 4  # run_training with the teacher: one warm-up step, three timed
TURNS = 2  # rounds of (teacher, offline, offline, teacher) step timings
# The scorecard, card against CPU (tests/test_torch_cuda.py's limits): the
# losses relative, the dB metrics, STOI and the F0 probes absolute.
SCORECARD_TOL = dict(mel_l1=("rel", 1e-3), stft_l1=("rel", 1e-3), snr_db=("abs", 0.05),
                     si_sdr_db=("abs", 0.05), mcd_db=("abs", 0.05), stoi=("abs", 1e-3),
                     f0_corr_prosody=("abs", 0.05), f0_corr_content=("abs", 0.05),
                     voicing_agree_prosody=("abs", 0.05), voicing_agree_content=("abs", 0.05))


def speechlike(seconds: float, sr: int, seed: int) -> np.ndarray:
    """A harmonic wave whose pitch glides around 100-250 Hz under a
    syllable-rate envelope, in [-0.5, 0.5]."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = rng.uniform(100, 180) * (1 + 0.25 * np.sin(2 * np.pi * rng.uniform(0.2, 0.6) * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = sum(np.sin(k * phase) / k for k in (1, 2, 3, 4, 5))
    env = 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(2.0, 4.0) * t)
    x = x * env + 0.01 * rng.standard_normal(len(t))
    return 0.5 * x / np.abs(x).max()


def own_data(d: str) -> tuple:
    """The wavs and their transcript in `d`: (transcript, {path: seconds})."""
    from scipy.io import wavfile

    files = {}
    for i, seconds in enumerate(OWN_SECONDS):
        path = os.path.join(d, f"utt{i}.wav")
        wavfile.write(path, SR, (speechlike(seconds, SR, i) * 32767).astype(np.int16))
        files[path] = seconds
    path = os.path.join(d, "utt8_u8_16k.wav")
    wavfile.write(path, 16000, (speechlike(3.0, 16000, 8) * 127 + 128).astype(np.uint8))
    files[path] = 3.0
    path = os.path.join(d, "utt9_f64_stereo_44k.wav")
    stereo = np.stack([speechlike(4.5, 44100, 9), speechlike(4.5, 44100, 19)], axis=1)
    wavfile.write(path, 44100, stereo.astype(np.float64))
    files[path] = 4.5
    transcript = os.path.join(d, "transcript.txt")
    with open(transcript, "w") as f:
        f.writelines(f"{p}\t{i}\ten\tutterance {i}\tphones\n" for i, p in enumerate(files))
    return transcript, files


def manifest_paths(manifest: str) -> list:
    with open(manifest) as f:
        return [line.split("\t")[0] for line in f if line.strip()]


def phase_own_targets(d: str, jdc_path: str, smi: str) -> dict:
    """12a: assemble_data, extract_targets on the card, the teacher's F0
    against a CPU teacher, and its time per second of audio."""
    from facodec_tpu_torch.cli import assemble_data, extract_targets
    from facodec_tpu_torch.models.jdc import load_jdc_checkpoint
    from facodec_tpu_torch.train.data import compute_mel
    from facodec_tpu_torch.utils.audio import load_wav

    log(f"phase 12a: training on one's own data: assemble_data, extract_targets --teachers jdc "
        f"on the card (seeded JDC file in the reference layout), F0 card against a CPU teacher "
        f"within {TEACHER_TOL} x max|F0| [{smi}]")
    transcript, files = own_data(d)
    if assemble_data.main(["--transcripts", transcript, "--target-dir", d, "--val-frac",
                           "0.2"]) != 0:
        raise AssertionError("assemble_data failed")
    train, val = (manifest_paths(os.path.join(d, n)) for n in ("train.txt", "val.txt"))
    if (len(train), len(val)) != (8, 2) or sorted(train + val) != sorted(files):
        raise AssertionError(f"assemble_data split {len(train)} / {len(val)}")
    t0 = time.perf_counter()
    for name in ("train.txt", "val.txt"):
        if extract_targets.main(["--manifest", os.path.join(d, name), "--teachers", "jdc",
                                 "--jdc-ckpt", jdc_path, "--device", "cuda"]) != 0:
            raise AssertionError(f"extract_targets on {name} failed")
    wall = time.perf_counter() - t0
    cpu, card = load_jdc_checkpoint(jdc_path, "cpu"), load_jdc_checkpoint(jdc_path, "cuda")
    worst, teacher_ms, audio_s = 0.0, 0.0, 0.0
    for path in train + val:
        wave = load_wav(path)
        frames = len(wave) // HOP
        mel = torch.from_numpy(compute_mel(wave[: frames * HOP]))[None]
        with torch.no_grad():
            want = cpu(mel)[0][0].numpy()
            mel_card = mel.to("cuda")
            ms = median_ms(lambda: card(mel_card))
        got = np.load(path + ".targets.npz")["f0"]
        gap = float(np.abs(got - want).max()) / float(np.abs(want).max())
        worst, teacher_ms, audio_s = max(worst, gap), teacher_ms + ms, audio_s + frames * HOP / SR
        log(f"  {os.path.basename(path)}: {frames} frames, F0 {want.min():.1f}-{want.max():.1f} "
            f"Hz, card against CPU {gap:.2e} of max|F0|, teacher {ms:.2f} ms on the card")
        if not (got.shape == want.shape and np.isfinite(got).all() and gap <= TEACHER_TOL):
            raise AssertionError(f"{path}: F0 {gap} of max|F0| off the CPU teacher")
    log(f"  extract_targets over {audio_s:.1f} s of audio in {wall:.2f} s (host clock, mels on "
        f"the host included); the teacher alone {teacher_ms:.2f} ms on the card, "
        f"{teacher_ms / audio_s:.3f} ms per second of audio [{smi}]")
    return dict(train=os.path.join(d, "train.txt"), val=os.path.join(d, "val.txt"),
                f0_max_rel=worst, teacher_ms_per_audio_s=teacher_ms / audio_s,
                extract_wall_s=wall)


def phase_own_train(data: dict, jdc_path: str, smi: str) -> dict:
    """12b: run_training with the inline teacher on the own data; the step
    with and without the teacher in turns; a draws-off step card against
    CPU; a split step."""
    import contextlib
    import io

    from facodec_tpu_torch.models.jdc import load_jdc_checkpoint
    from facodec_tpu_torch.train.data import FileListDataset
    from facodec_tpu_torch.train.step import with_teacher_f0

    log(f"phase 12b: run_training(fields=FLAGSHIP_TRAIN, dataset=FileListDataset(train.txt), "
        f"F0_path=<seeded JDC file>, device='cuda'), batch {TRAIN_BATCH} x {TRAIN_FRAMES} "
        f"frames, {OWN_STEPS} steps (1 warm-up) [{smi}]")
    log_dir = tempfile.mkdtemp(prefix="own_smoke_", dir=build.BUILD_DIR)
    try:
        out = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(out):
            state = run_training(fields=FLAGSHIP_TRAIN, dataset=FileListDataset(data["train"]),
                                 device="cuda", F0_path=jdc_path, max_steps=OWN_STEPS,
                                 log_dir=log_dir, log_writer=False, log_interval=1,
                                 save_interval=10**9, save_freq=10**9)
        run_counts = all_counts()
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    printed = out.getvalue()
    log("  run_training printed: " + printed.strip().replace("\n", " | "))
    if f"inline F0 teacher: {jdc_path}" not in printed:
        raise AssertionError("run_training did not load the inline teacher")
    c = run_counts
    if (c["f32"], c["vq"], c["bf16"], c["halo"]) != (24 * OWN_STEPS, 6 * OWN_STEPS, 0, 0):
        raise AssertionError(f"launches {c} over {OWN_STEPS} steps with the teacher")
    for k, v in sorted(state.metrics.items()):
        if not np.isfinite(v):
            raise AssertionError(f"{k} is not finite: {v}")
    times = [1e3 * state.step_times[s] for s in range(2, OWN_STEPS + 1)]
    log(f"  {OWN_STEPS} steps, every loss finite (loss/f0 {state.metrics['loss/f0']:.4g}, "
        f"loss/gen_all {state.metrics['loss/gen_all']:.4g}); launches per step "
        f"{c['f32'] // OWN_STEPS} residual units, {c['vq'] // OWN_STEPS} VQ; step ms "
        + ", ".join(f"{t:.1f}" for t in times))

    # the step with the teacher against the same step fed the batch's F0, in turns
    teacher = load_jdc_checkpoint(jdc_path, "cuda")
    ds = FileListDataset(data["train"])
    batch = to_device(segment_batch(collate([ds[i] for i in range(TRAIN_BATCH)], 80),
                                    max_frames=TRAIN_FRAMES,
                                    generator=torch.Generator().manual_seed(12)), "cuda")
    steps = dict(teacher=make_codec_train_step(state.models, state.optimizers,
                                               f0_teacher=teacher),
                 offline=make_codec_train_step(state.models, state.optimizers))
    gen = torch.Generator(device="cuda").manual_seed(12)
    ms = dict(teacher=[], offline=[])
    for name in ("teacher", "offline"):  # one warm step each
        float(steps[name](batch, gen)[0]["loss/gen_all"])
    for _ in range(TURNS):
        for name in ("teacher", "offline", "offline", "teacher"):
            t0 = time.perf_counter()
            float(steps[name](batch, gen)[0]["loss/gen_all"])
            ms[name].append(1e3 * (time.perf_counter() - t0))
    with torch.no_grad():
        teacher_ms = median_ms(lambda: with_teacher_f0(teacher, batch))
    med = {k: statistics.median(v) for k, v in ms.items()}
    log(f"  step ms in turns (host clock until the metrics are read): with the teacher "
        + ", ".join(f"{t:.1f}" for t in ms["teacher"]) + f" (median {med['teacher']:.1f}); "
        f"batch F0 " + ", ".join(f"{t:.1f}" for t in ms["offline"])
        + f" (median {med['offline']:.1f}); the teacher alone on the batch's mel "
        f"({TRAIN_BATCH} x {TRAIN_FRAMES} frames) {teacher_ms:.3f} ms on the card [{smi}]")
    del steps, state, teacher
    torch.cuda.empty_cache()

    # one draws-off step with the teacher, card against CPU (10b's check)
    log(f"  draws-off step with the teacher, FLAGSHIP_TRAIN seed 7, batch 1 x 20 frames, card "
        f"against CPU: losses and gradient norms within {STEP_TOL} relative")
    metrics = {}
    for device in ("cpu", "cuda"):
        t0 = time.perf_counter()
        models = draws_off(build_models(FLAGSHIP_TRAIN, 7, device))
        step = make_codec_train_step(models, build_optimizers(models),
                                     f0_teacher=load_jdc_checkpoint(jdc_path, device))
        b1 = train_batch(1, 20, 3, device, max_s=2.0)
        metrics[device] = {k: float(v) for k, v in step(b1, None)[0].items()}
        log(f"  {device}: built and stepped in {time.perf_counter() - t0:.1f} s")
        del models, step
    worst = 0.0
    for k in sorted(metrics["cpu"]):
        a, b = metrics["cuda"][k], metrics["cpu"][k]
        rel = abs(a - b) / max(abs(b), 1e-12)
        worst = max(worst, rel)
        if not (np.isfinite(a) and rel <= STEP_TOL):
            raise AssertionError(f"{k}: card {a} against CPU {b}")
    log(f"  every loss and gradient norm within {worst:.2e} relative (loss/f0 card "
        f"{metrics['cuda']['loss/f0']:.6g} cpu {metrics['cpu']['loss/f0']:.6g})")

    # one split step with the teacher
    models = build_models(FLAGSHIP_TRAIN, 0, "cuda")
    step = make_codec_train_step_split(models, build_optimizers(models),
                                       f0_teacher=load_jdc_checkpoint(jdc_path, "cuda"))
    reset_counts()
    split = {k: float(v) for k, v in step(batch, torch.Generator(device="cuda")
                                          .manual_seed(3))[0].items()}
    c = all_counts()
    if (c["f32"], c["vq"]) != (48, 12) or not all(np.isfinite(v) for v in split.values()):
        raise AssertionError(f"split step with the teacher: launches {c}, metrics {split}")
    log(f"  split step with the teacher: every loss finite, launches {c['f32']} residual units, "
        f"{c['vq']} VQ (two generator forwards)")
    del models, step
    torch.cuda.empty_cache()
    return dict(step_ms=med["teacher"], offline_step_ms=med["offline"], teacher_ms=teacher_ms,
                step_max_rel=worst, times=times,
                per_step=dict(f32=run_counts["f32"] // OWN_STEPS, vq=run_counts["vq"] // OWN_STEPS))


def scorecard_line(card: dict) -> str:
    return ", ".join(f"{k} {v:.4g}" for k, v in card.items() if isinstance(v, float)) + (
        ", code_usage " + " / ".join(f"{v:.4f}" for v in card["code_usage"].values()))


def phase_scorecard(data: dict, smi: str) -> dict:
    """12c: evaluate.main on val.txt; evaluate_utterance under float32 and
    hybrid on 4 x 10 s; one utterance card against CPU."""
    from facodec_tpu_torch.cli import evaluate
    from facodec_tpu_torch.cli.evaluate import AGG_KEYS, evaluate_utterance
    from facodec_tpu_torch.ops.metrics import si_sdr
    from facodec_tpu_torch.utils.audio import load_wav

    log(f"phase 12c: the evaluate scorecard: evaluate.main on val.txt with the flagship codec "
        f"(FLAGSHIP, seed 0) on the card; evaluate_utterance float32 and hybrid on "
        f"{BATCH} x {SECONDS:.0f} s; card against CPU on one utterance [{smi}]")
    out_json = os.path.join(os.path.dirname(data["val"]), "eval.json")
    n_val = len(manifest_paths(data["val"]))
    reset_counts()
    t0 = time.perf_counter()
    if evaluate.main(["--manifest", data["val"], "--json", out_json, "--device", "cuda"]) != 0:
        raise AssertionError("evaluate.main failed")
    wall = time.perf_counter() - t0
    c = all_counts()
    if (c["f32"], c["vq"], c["bf16"], c["halo"]) != (48 * n_val, 6 * n_val, 0, 0):
        raise AssertionError(f"evaluate.main on {n_val} utterances launched {c}")
    with open(out_json) as f:
        agg = json.load(f)["aggregate"]
    if set(agg) != set(AGG_KEYS):
        raise AssertionError(f"aggregate keys {sorted(agg)}")
    for k, v in agg.items():
        if v is not None and not np.isfinite(v):
            raise AssertionError(f"aggregate {k} = {v}")
    log(f"  evaluate.main: {n_val} utterances in {wall:.1f} s (the codec's build included); "
        f"aggregate {json.dumps(agg)}; launches {c}")

    codec = FACodec.from_fields(FLAGSHIP, seed=0, device="cuda")
    codec_hy = FACodec(codec.encoder, codec.quantizer, codec.decoder, precision="hybrid")
    w = sweep_wave(BATCH, SECONDS)
    cards, eval_ms, launches = {}, {}, {}
    for name, c_ in (("float32", codec), ("hybrid", codec_hy)):
        evaluate_utterance(c_, w[0])  # warm-up
        reset_counts()
        t0 = time.perf_counter()
        cards[name] = [evaluate_utterance(c_, w[i]) for i in range(BATCH)]
        eval_ms[name] = 1e3 * (time.perf_counter() - t0) / BATCH
        launches[name] = {k: v // BATCH for k, v in all_counts().items()}
        for i, card in enumerate(cards[name]):
            log(f"  {name} wave {i}: " + scorecard_line(card))
        log(f"  {name}: {eval_ms[name]:.1f} ms per {SECONDS:.0f} s utterance (host clock); "
            f"launches per utterance {launches[name]}")
    if launches["float32"] != dict(f32=48, bf16=0, halo=0, vq=6) or launches["hybrid"] != dict(
            f32=12, bf16=36, halo=0, vq=6):
        raise AssertionError(f"evaluate_utterance launches {launches}")
    f = codec.encode(w)
    y32, yhy = codec.decode(f), codec_hy.decode(f)
    hy_vs_f32 = [si_sdr(yhy[i], y32[i]) for i in range(BATCH)]
    log("  SI-SDR of the hybrid reconstruction against the float32 one (same codes): "
        + ", ".join(f"{v:.2f}" for v in hy_vs_f32) + " dB")
    del codec_hy

    # card against CPU on one utterance (the first 1.5 s of a val wav)
    wave = load_wav(manifest_paths(data["val"])[0])[: int(1.5 * SR)]
    cpu = FACodec.from_fields(FLAGSHIP, seed=0, device="cpu")
    got, want = evaluate_utterance(codec, wave), evaluate_utterance(cpu, wave)
    fc, fg = cpu.encode(wave), codec.encode(wave)
    match = float(np.mean(np.concatenate([(getattr(fg, s) == getattr(fc, s)).ravel()
                                          for s in ("codes_p", "codes_c", "codes_r")])))
    log(f"  card against CPU, 1.5 s: codes {match:.4f} equal (>= {CODE_MATCH_MIN}); "
        + ", ".join(f"{k} {got[k]:.6g} / {want[k]:.6g}" for k in SCORECARD_TOL))
    if match < CODE_MATCH_MIN:
        raise AssertionError(f"codes {match} equal, card against CPU")
    for k, (kind, tol) in SCORECARD_TOL.items():
        if np.isnan(want[k]):
            if not np.isnan(got[k]):
                raise AssertionError(f"{k}: card {got[k]}, CPU NaN")
            continue
        limit = tol * abs(want[k]) if kind == "rel" else tol
        if not abs(got[k] - want[k]) <= limit:
            raise AssertionError(f"{k}: card {got[k]} against CPU {want[k]} (limit {limit})")
    del codec, cpu
    torch.cuda.empty_cache()
    return dict(eval_launches=launches, eval_ms=eval_ms, hybrid_si_sdr_db=hy_vs_f32,
                aggregate=agg, f32_card=cards["float32"], hybrid_card=cards["hybrid"])


def phase_own(smi: str) -> tuple:
    """Phase 12 in a scratch directory of the build tree: 12a, 12b, 12c."""
    from facodec_tpu_torch.models.jdc import random_reference_state_dict

    d = tempfile.mkdtemp(prefix="own_data_", dir=build.BUILD_DIR)
    try:
        jdc_path = os.path.join(d, "bst.t7")
        torch.save({"net": random_reference_state_dict(0)}, jdc_path)
        t0 = time.perf_counter()
        data = phase_own_targets(d, jdc_path, smi)
        t1 = time.perf_counter()
        tr = phase_own_train(data, jdc_path, smi)
        t2 = time.perf_counter()
        sc = phase_scorecard(data, smi)
        log(f"phase 12: 12a {t1 - t0:.1f} s, 12b {t2 - t1:.1f} s, 12c "
            f"{time.perf_counter() - t2:.1f} s")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return data, tr, sc


ARTIFACT_F32_TOL = 1e-5  # a float32 artifact's waves against the live codec's, max abs
ARTIFACT_HYBRID_TOL = 1e-3  # a hybrid artifact's waves against the live hybrid codec's, err/scale
ARTIFACT_TURNS = 1  # timed reconstructs of each, live then artifact


def check_artifact_wave(label: str, prec: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """A float32 artifact's max abs gap, a hybrid one's err/scale at the
    worst sample, each held to its limit."""
    g, w_ = got.cpu().numpy(), want.cpu().numpy()
    if g.shape != w_.shape or not np.isfinite(g).all():
        raise AssertionError(f"{label}: {g.shape} against {w_.shape}, or not finite")
    if prec == "float32":
        gap, limit, what = float(np.abs(g - w_).max()), ARTIFACT_F32_TOL, "max abs"
    else:
        gap, limit, what = wave_gap(g, w_)[0], ARTIFACT_HYBRID_TOL, "err/scale"
    log(f"  {label}: {what} {gap:.3e} from live (limit {limit}); bit-equal "
        f"{bool(np.array_equal(g, w_))}")
    if not gap <= limit:
        raise AssertionError(f"{label}: {what} {gap} > {limit}")
    return gap


def phase_artifact(codec: FACodec, w: np.ndarray, smi: str) -> dict:
    """Phase 13: export hybrid (all five functions) and float32
    (`reconstruct_masked`) artifacts of the flagship codec at batch B x 10 s, load
    them with the weights of a port checkpoint, hold them to the live codec
    (codes equal, waves, launches), time them against it in turns, and serve
    the hybrid one over HTTP against a live CodecService."""
    B, T = w.shape
    log(f"phase 13: AOT export (torch.export) and serve --artifact, flagship, batch {B} x "
        f"{SECONDS:.0f} s [{smi}]")
    codec_hy = FACodec(codec.encoder, codec.quantizer, codec.decoder, precision="hybrid")
    live = {"float32": codec, "hybrid": codec_hy}
    tmp = tempfile.mkdtemp(prefix="facodec_artifact_")
    try:
        ckpt = os.path.join(tmp, "codec.pth")
        torch.save({k: getattr(codec, k).state_dict() for k in export.MODULES}, ckpt)
        ckpt_bytes = os.path.getsize(ckpt)
        dirs, export_s, art_bytes = {}, {}, {}
        for prec, fns in (("hybrid", tuple(export.FUNCTIONS)),
                          ("float32", ("reconstruct_masked",))):
            dirs[prec] = os.path.join(tmp, prec)
            rep = export.export_codec(live[prec], dirs[prec], batch=B, seconds=SECONDS,
                                      functions=fns)
            export_s[prec] = {n: r["seconds"] for n, r in rep.items()}
            art_bytes[prec] = sum(r["bytes"] for r in rep.values())
            log(f"  export {prec}: " + ", ".join(f"{n} {r['seconds']:.1f} s, {r['bytes']} B"
                                                  for n, r in rep.items())
                + f"; {art_bytes[prec]} B in all, the checkpoint {ckpt_bytes} B [{smi}]")
            if not art_bytes[prec] < ckpt_bytes:
                raise AssertionError(f"the {prec} artifact ({art_bytes[prec]} B) is not smaller "
                                     f"than the checkpoint ({ckpt_bytes} B)")

        wt = torch.from_numpy(w).cuda()
        lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exported = {"hybrid": export.ExportedCodec(dirs["hybrid"])}
        params = exported["hybrid"].load_params(ckpt)
        t_load = time.perf_counter() - t0  # meta.json and the weights; programs load on use
        exported["hybrid"].reconstruct_masked(params, wt, lens)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        exported["float32"] = export.ExportedCodec(dirs["float32"])
        t0 = time.perf_counter()
        fresh = FACodec.from_fields(FLAGSHIP, ckpt_path=ckpt, precision="hybrid", device="cuda")
        svc = serve_cli.CodecService(fresh, bucket_seconds=SECONDS)
        t_build = time.perf_counter() - t0
        t_warm = svc.warmup()
        svc.close()
        del fresh
        log(f"  hybrid artifact: ExportedCodec + load_params {t_load:.2f} s, then the first "
            f"reconstruct_masked with its program's load, {t_first:.2f} s in all; live: FACodec.from_fields + checkpoint {t_build:.2f} s, "
            f"CodecService.warmup {t_warm:.2f} s [{smi}]")

        launches, gaps, times = {}, {}, {}
        for prec in ("float32", "hybrid"):
            exp, c = exported[prec], live[prec]
            with torch.no_grad():
                # the hybrid artifact's encode is the float32 encode (the
                # float32 artifact exports only reconstruct_masked)
                _, codes, timbre = c.encode_tensor(wt, lens)
                cp, cc, cr, tm = exported["hybrid"].encode_masked(params, wt, lens)
                for name, a, b in zip(("codes_p", "codes_c", "codes_r"), (cp, cc, cr), codes):
                    if not torch.equal(a, b):
                        raise AssertionError(f"the hybrid artifact's {name} differ from the "
                                             f"live {prec} codec's "
                                             f"({int((a != b).sum())} of {a.numel()})")
                if not torch.equal(tm, timbre):
                    raise AssertionError(f"the hybrid artifact's timbre differs from the live "
                                         f"{prec} codec's")
                reset_counts()
                y_art = exp.reconstruct_masked(params, wt, lens)
                torch.cuda.synchronize()
                n_art = all_counts()
                reset_counts()
                y_live = c.decode_latent(c.encode_tensor(wt, lens)[0])
                torch.cuda.synchronize()
                n_live = all_counts()
            log(f"  {prec}: codes and timbre equal to live's; reconstruct_masked launches "
                f"{n_art} (live {n_live})")
            if n_art != n_live:
                raise AssertionError(f"{prec}: the artifact launched {n_art}, live {n_live}")
            launches[prec] = n_art
            gaps[prec] = check_artifact_wave(f"{prec} reconstruct_masked", prec, y_art, y_live)
            if prec == "hybrid":  # the artifact's other three functions
                with torch.no_grad():
                    enc = exp.encode(params, wt)
                    _, codes, timbre = c.encode_tensor(wt)
                    for a, b in zip(enc, (*codes, timbre)):
                        if not torch.equal(a, b):
                            raise AssertionError("hybrid artifact encode differs from live's")
                    gaps["hybrid_decode"] = check_artifact_wave(
                        "hybrid decode", prec, exp.decode(params, *enc),
                        c.decode_tensor(*enc))
                    gaps["hybrid_reconstruct"] = check_artifact_wave(
                        "hybrid reconstruct", prec, exp.reconstruct(params, wt),
                        c.decode_latent(c.encode_tensor(wt)[0]))
            runs = {"live": lambda: c.decode_latent(c.encode_tensor(wt, lens)[0]),
                    "artifact": lambda: exp.reconstruct_masked(params, wt, lens)}
            times[prec] = {"live": [], "artifact": []}
            for i in range(ARTIFACT_TURNS):
                for k in (("live", "artifact") if i % 2 == 0 else ("artifact", "live")):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    runs[k]()
                    torch.cuda.synchronize()
                    times[prec][k].append(1e3 * (time.perf_counter() - t0))
            med = {k: statistics.median(v) for k, v in times[prec].items()}
            log(f"  {prec} reconstruct, {ARTIFACT_TURNS} each in turns: live "
                + ", ".join(f"{t:.2f}" for t in times[prec]["live"]) + " ms, artifact "
                + ", ".join(f"{t:.2f}" for t in times[prec]["artifact"])
                + f" ms; medians {med['live']:.2f} / {med['artifact']:.2f} ms "
                f"({med['artifact'] - med['live']:+.2f} ms) [{smi}]")
            times[prec]["median"] = med
        served = phase_artifact_serve(dirs["hybrid"], params, codec_hy, smi)
        return dict(launches=launches, gaps=gaps, times=times, export_s=export_s,
                    art_bytes=art_bytes, ckpt_bytes=ckpt_bytes, t_load=t_load, t_first=t_first,
                    t_build=t_build, t_warm=t_warm, **served)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _concurrent_rps(base: str, blobs: list) -> tuple:
    """(requests/s, outputs) of len(blobs) concurrent /reconstruct requests."""
    results, errors = [None] * len(blobs), []

    def worker(i):
        try:
            results[i] = serve_cli.read_wav_bytes(_http("POST", f"{base}/reconstruct", blobs[i]))
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(blobs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    elapsed = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"concurrent requests failed: {errors}")
    return len(blobs) / elapsed, results


def phase_artifact_serve(art_dir: str, params: dict, codec_hy: FACodec, smi: str) -> dict:
    """13b: 8 concurrent 10 s /reconstruct requests to an ArtifactService
    (batch 4) and to a live CodecService of the same batch cap and bucket,
    in turns (live, artifact)."""
    n_req = 8
    art = serve_cli.ArtifactService(art_dir, params, batch_window_ms=200.0)
    live = serve_cli.CodecService(codec_hy, bucket_seconds=SECONDS, max_batch=art.max_batch,
                                  batch_window_ms=200.0)
    servers = {k: serve_cli.make_server(v, "127.0.0.1", 0)
               for k, v in (("artifact", art), ("live", live))}
    for server in servers.values():
        threading.Thread(target=server.serve_forever, daemon=True).start()
    base = {k: f"http://127.0.0.1:{v.server_address[1]}" for k, v in servers.items()}
    log(f"phase 13b: serve --artifact ({base['artifact']}) against live CodecService "
        f"({base['live']}), hybrid, batch cap {art.max_batch}, bucket {SECONDS:.0f} s, "
        f"{n_req} concurrent requests of {SECONDS:.0f} s")
    try:
        blobs = [serve_cli.write_wav_bytes(x) for x in sweep_wave(n_req, SECONDS, seed=30)]
        waves = [serve_cli.read_wav_bytes(b) for b in blobs]  # as the server reads them
        for b in base.values():
            _http("POST", f"{b}/reconstruct", blobs[0])  # warm up
        rps = {"live": [], "artifact": []}
        calls0 = art._batcher.calls
        reset_counts()
        outs = None
        for k in ("live", "artifact"):
            r, got = _concurrent_rps(base[k], blobs)
            rps[k].append(r)
            if k == "artifact":
                outs = got
        n = all_counts()
        calls = art._batcher.calls - calls0
        log(f"  requests/s (in turns): live {', '.join(f'{r:.2f}' for r in rps['live'])}; "
            f"artifact {', '.join(f'{r:.2f}' for r in rps['artifact'])}; the artifact's "
            f"{n_req} requests ran as {calls} device calls; launches of both rounds "
            f"{n} [{smi}]")
        # each served wave against the live hybrid codec's reconstruct of the
        # request padded into a batch of the artifact's size, through WAV
        served_gap = 0.0
        for i, x in enumerate(waves):
            batch = np.zeros((art.max_batch, x.shape[-1]), np.float32)
            batch[0] = x
            with torch.no_grad():
                y = codec_hy.decode_latent(codec_hy.encode_tensor(torch.from_numpy(batch).cuda())[0])
            want = serve_cli.read_wav_bytes(serve_cli.write_wav_bytes(y[:1].cpu().numpy()))
            served_gap = max(served_gap, check_hybrid_gap(f"served request {i} vs live", outs[i],
                                                          want)[0])
        health = json.loads(_http("GET", f"{base['artifact']}/health"))
        metrics = _http("GET", f"{base['artifact']}/metrics").decode()
        if health.get("artifact") is not True or "facodec_artifact 1" not in metrics:
            raise AssertionError(f"artifact /health {health}")
        log(f"  /health {health}")
        return dict(rps_artifact=rps["artifact"], rps_live=rps["live"], served_gap=served_gap,
                    serve_calls=calls)
    finally:
        for server in servers.values():
            server.shutdown()
            server.server_close()
        art.close()
        live.close()


# ------------------------------------------------------------- phase 14
DP_STEPS = 3  # 14a: steps of each plain run; the data-parallel run is cut at DP_CUT, then resumed
DP_CUT = 2  # its epoch's checkpoint is step DP_CUT - 1's: the resumed run starts from there
RED_DP_STEPS = 2  # 14c: the same for run_redecoder_training
DP_ITEMS = 4  # 14a-c: utterances (PseudoDataset seed 0): one batch of 4, one epoch, per step
DP_GRAD_TOL = 1e-4  # 14b: the reduced gradients, of max|g| per module (the card's standard)
DP_STEP_TOL = dict(rtol=2e-3, atol=2e-4)  # metrics and updated parameters (tests/test_parallel.py)
SHARD_F32_TOL = 1e-5  # 14d: float32 waves and timbre, sharded against unsharded, max abs
# 14d: hybrid waves against the unsharded codec on each replica's rows (the
# same batch: the artifact phase's standard), err / scale. Against the
# unsharded call on all rows, a replica's decode is another batch's (2 + 1
# rows against 3; 14e: 4 + 4 against 8), which is HYBRID_BF16's case.
SHARD_HYBRID_TOL = 1e-3
SHARD_BATCH, SHARD_TURNS = 3, 3
NO_SAVE = 10**9  # save_interval / save_freq of a run that writes no checkpoint


@contextlib.contextmanager
def deterministic():
    """PyTorch's and cuDNN's deterministic algorithms inside the block: on
    the card a training step's backward otherwise sums some gradients by
    atomic adds in a varying order, so two plain runs from one seed differ
    in the last bits (grad_norm/encoder 10.223515 against 10.223517 in the
    first card run of phase 14). Ops without a deterministic form run as
    they are (`warn_only`; their warnings are silenced)."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*deterministic.*")
            yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic = saved[2]


def _timed_reduce():
    """Wrap `mesh.all_reduce_mean_` with CUDA events: returns (events, undo)."""
    orig = mesh.all_reduce_mean_
    events = []

    def timed(tensors, *args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        orig(tensors, *args, **kwargs)
        end.record()
        events.append((start, end))

    mesh.all_reduce_mean_ = timed

    def undo():
        mesh.all_reduce_mean_ = orig

    return events, undo


@contextlib.contextmanager
def _world_env(world: int):
    """torchrun's environment for this process as rank 0 of `world`, at a
    store it holds (`mesh.rank_store`), restored when the block ends."""
    keys = (*mesh.ENV_KEYS, "LOCAL_WORLD_SIZE", "TORCHELASTIC_USE_AGENT_STORE")
    saved = {k: os.environ.get(k) for k in keys}
    try:
        with mesh.rank_store() as store_env:
            os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE=str(world),
                              LOCAL_WORLD_SIZE=str(world), **store_env)
            yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dp_items() -> list:
    """DP_ITEMS PseudoDataset utterances (seed 0, 1-30 s, the flagship's
    label ranges) as a list: the loops read one batch of 4 per epoch, in the
    same order in every run and on every rank, so a run resumed from an
    epoch's checkpoint goes on as the run it was cut from."""
    ds = PseudoDataset(length=DP_ITEMS, seed=0)
    return [ds[i] for i in range(DP_ITEMS)]


_SEEDED: dict = {}  # seed -> FLAGSHIP_TRAIN's seeded weights (CPU state dicts), per process


def reused_build(fields, seed: int, device: str) -> dict:
    """`train.loop.build_models` for `dp_train`'s runs, which build
    FLAGSHIP_TRAIN many times in one process (14a, 14b's ranks and
    one-process runs, 17a): the seeded weights are drawn on the CPU once per
    process and seed, and later builds load them into new modules, the very
    values a new draw gives."""
    from facodec_tpu_torch.models.builder import build_train_from_fields
    from facodec_tpu_torch.train import loop as loop_mod

    if fields is not FLAGSHIP_TRAIN:
        raise ValueError("reused_build serves FLAGSHIP_TRAIN")
    if seed not in _SEEDED:
        models = build_models(fields, seed, "cpu")
        _SEEDED[seed] = {k: {n: t.clone() for n, t in m.state_dict().items()}
                         for k, m in models.items()}
    else:
        models = build_train_from_fields(fields)
        for k, m in models.items():
            m.load_state_dict(_SEEDED[seed][k])
    return {k: models[k].to(device) for k in loop_mod.MODULES}


def dp_train(kind: str, device: str, log_dir: str, max_steps: int, record_grads: bool = False,
             **options) -> dict:
    """`run_training(fields=FLAGSHIP_TRAIN)` ("codec") or
    `run_redecoder_training(fields=FLAGSHIP_REDECODER_TRAIN)` ("redecoder")
    on `dp_items()`, as a user calls it: where this process is a rank
    (torchrun's environment, or a group already formed) the loop joins the
    group and trains data-parallel, else it trains alone. No checkpoint
    unless `options` ask for one. Returns the step reached, the last
    step's metrics, the parameters (on the CPU), the host ms of each step,
    the kernel launches and all-reduce calls and bytes of the run, the rows
    each codec batch kept ([global wave_lens, this process's]), and with
    `record_grads` the last step's gradients as each update took them
    (reduced over the ranks: recorded at train/step.py's
    `reduce_gradients`)."""
    from facodec_tpu_torch.train import loop as loop_mod
    from facodec_tpu_torch.train import step as step_mod

    grads, rows = {}, []
    reduce, cut, build_fn = step_mod.reduce_gradients, loop_mod.rank_batch, loop_mod.build_models

    def recording_reduce(params, gs):
        out = reduce(params, gs)
        for p, g in zip(params, out):
            grads[id(p)] = None if g is None else g.detach().clone()
        return out

    def recording_cut(batch):
        out = cut(batch)
        rows.append([batch["wave_lens"].tolist(), out["wave_lens"].tolist()])
        return out

    if record_grads:
        step_mod.reduce_gradients = recording_reduce
    loop_mod.rank_batch = recording_cut
    loop_mod.build_models = reused_build
    options = dict(dict(save_interval=NO_SAVE, save_freq=NO_SAVE), **options)
    calls, nbytes = mesh.REDUCED.calls, mesh.REDUCED.bytes
    model = (mesh.MODEL_SUMS.calls + mesh.GATHERED.calls, mesh.MODEL_SUMS.bytes + mesh.GATHERED.bytes)
    reset_counts()
    try:
        if kind == "codec":
            state = run_training(fields=FLAGSHIP_TRAIN, dataset=dp_items(), max_steps=max_steps,
                                 device=device, log_dir=log_dir, log_writer=False, log_interval=1,
                                 **options)
        else:
            state = run_redecoder_training(fields=FLAGSHIP_REDECODER_TRAIN, dataset=dp_items(),
                                           max_steps=max_steps, device=device, log_dir=log_dir,
                                           log_writer=False, log_interval=1, **options)
    finally:
        step_mod.reduce_gradients, loop_mod.rank_batch, loop_mod.build_models = reduce, cut, build_fn
    launches = policy_counts()

    def whole(t, p):
        """A shard of a tensor-parallel run gathered whole (every rank calls it)."""
        return (mesh.gather_model(t, 0) if mesh.is_sharded(p) else t).cpu()

    named = [(f"{k}.{n}", p) for k, m in state.models.items() for n, p in m.named_parameters()]
    elem = [(p.numel() * p.element_size(), (p.tp_shard[1] if mesh.is_sharded(p) else 1))
            for _, p in named]
    sharded = [(b, n) for b, n in elem if n > 1]
    out = dict(step=state.step, metrics=dict(state.metrics), launches=launches, rows=rows,
               step_ms={s: 1e3 * t for s, t in state.step_times.items()},
               reduced=[mesh.REDUCED.calls - calls, mesh.REDUCED.bytes - nbytes],
               model=[mesh.MODEL_SUMS.calls + mesh.GATHERED.calls - model[0],
                      mesh.MODEL_SUMS.bytes + mesh.GATHERED.bytes - model[1]],
               sharded=[k for k, p in named if mesh.is_sharded(p)],
               # this process's parameter bytes (AdamW keeps two moments of each), and
               # the same tensors whole
               param_bytes=[sum(b for b, _ in elem), sum(b * n for b, n in elem)],
               sharded_bytes=[sum(b for b, _ in sharded), sum(b * n for b, n in sharded)],
               params={k: whole(p.detach(), p) for k, p in named})
    if record_grads:
        out["grads"] = {k: [None if grads.get(id(p)) is None else whole(grads[id(p)], p)
                            for p in m.parameters()] for k, m in state.models.items()}
    del state, grads
    torch.cuda.empty_cache()
    return out


def _digest(t) -> str:
    """A tensor's bytes, hashed (None for None)."""
    if t is None:
        return None
    return hashlib.sha1(t.contiguous().numpy().view(np.uint8)).hexdigest()


def dp_rank(spec_path: str) -> None:
    """One spawned rank of 14a/14b and 17a (`dp_ranks`): where the spec names
    a backend, it forms the group over it first (gloo: two ranks on one
    card, which NCCL refuses); else `run_training` joins it from torchrun's
    environment. Runs `dp_train` for each of the spec's runs (a run with
    `tp` at `tensor_parallel=TP_MODEL`; under gloo every run's collectives
    timed alike, `_time_collectives`, so that 14b's and 17a's step ms are
    taken the same way) and writes the results to <out>/rank<r>.pt; a rank
    other than 0 writes its parameters and gradients as digests, which
    `_same_on_ranks` holds to rank 0's tensors."""
    spec = torch.load(spec_path, weights_only=False)
    if spec["backend"]:
        mesh.init_distributed(spec["device"], spec["backend"])
    results = []
    for run in spec["runs"]:
        records, undo = [], (lambda: None)
        args = dict(run["args"])
        if spec["backend"] == "gloo":
            undo = _time_collectives(records)
        if run.get("tp"):
            args["tensor_parallel"] = TP_MODEL
        try:
            r = dp_train("codec", spec["device"], run["log_dir"], record_grads=True, **args)
        finally:
            undo()
        r["collectives"] = records
        if mesh.world_rank()[0] != 0:
            r["params"] = {k: _digest(v) for k, v in r["params"].items()}
            r["grads"] = {k: [_digest(g) for g in gs] for k, gs in r["grads"].items()}
        results.append(r)
    torch.save(results, os.path.join(spec["out"], f"rank{mesh.world_rank()[0]}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def _same_on_ranks(label: str, res: list) -> None:
    """Every rank's gradients and parameters are rank 0's, bit for bit."""
    for rr in res[1:]:
        for mod, grads in res[0]["grads"].items():
            if [_digest(g) for g in grads] != rr["grads"][mod]:
                raise AssertionError(f"{label}: the ranks' {mod} gradients differ")
        for k, v in res[0]["params"].items():
            if _digest(v) != rr["params"][k]:
                raise AssertionError(f"{label}: the ranks' {k} differ")


def _same_run(label: str, got: dict, want: dict) -> None:
    if got["step"] != want["step"] or got["metrics"] != want["metrics"]:
        raise AssertionError(f"{label}: step {got['step']} metrics {got['metrics']} against "
                             f"step {want['step']} {want['metrics']}")
    for k, v in want["params"].items():
        if not torch.equal(got["params"][k], v):
            raise AssertionError(f"{label}: {k} differs")


def _per_step(run: dict) -> dict:
    steps = len(run["step_ms"])
    return {k: v / steps for k, v in run["launches"].items()}


def _reduce_ms(events: list, steps: int) -> list:
    """The all-reduce's device ms of each step of a run, from its events."""
    torch.cuda.synchronize()
    per = len(events) // steps
    return [sum(s.elapsed_time(e) for s, e in events[i * per:(i + 1) * per])
            for i in range(steps)]


def phase_dp_nccl(smi: str) -> dict:
    """14a and 14c: `run_training` and `run_redecoder_training` as torchrun
    starts them, in this process as rank 0 of an NCCL group of one (its
    environment set: the loops join the group, broadcast the parameters,
    reduce every gradient, write as rank 0 and wait at the barrier after a
    save), against the same calls in this process alone, in turns: plain,
    data-parallel cut at step DP_CUT after an epoch's checkpoint,
    data-parallel resumed from that checkpoint, plain again (the group gone).
    All under `deterministic()`; the runs must end bit-equal."""
    world = math.gcd(TRAIN_BATCH, torch.cuda.device_count())
    d = tempfile.mkdtemp(prefix="dp_nccl_", dir=build.BUILD_DIR)
    events, undo = _timed_reduce()
    runs, red, reduce_ms = {}, {}, []
    log(f"phase 14a: run_training(fields=FLAGSHIP_TRAIN) as rank 0 of an NCCL group of one "
        f"(torchrun's environment, WORLD_SIZE=1), {DP_ITEMS} PseudoDataset utterances, batch "
        f"{TRAIN_BATCH} x {TRAIN_FRAMES} frames, draws on: plain {DP_STEPS} steps; data-parallel "
        f"cut at step {DP_CUT} (an epoch's checkpoint at step {DP_CUT - 1}) and resumed to "
        f"{DP_STEPS}; plain again; under deterministic algorithms, bit-equal [{smi}]")
    try:
        with deterministic():
            runs["plain"] = dp_train("codec", "cuda", f"{d}/plain", DP_STEPS)
            red["plain"] = dp_train("redecoder", "cuda", f"{d}/red_plain", RED_DP_STEPS)
            with _world_env(1):
                try:
                    for key, steps, opts in (("cut", DP_CUT, dict(save_freq=1)),
                                             ("resumed", DP_STEPS, {})):
                        n0 = len(events)
                        runs[key] = dp_train("codec", "cuda", f"{d}/dp", steps, **opts)
                        reduce_ms += _reduce_ms(events[n0:], len(runs[key]["step_ms"]))
                        if key == "cut":
                            backend = torch.distributed.get_backend()
                            ckpt = latest_checkpoint(f"{d}/dp")
                            if backend != "nccl" or not (ckpt or "").endswith(
                                    f"_step_{DP_CUT - 1:05d}.pth"):
                                raise AssertionError(f"14a: backend {backend}, checkpoint "
                                                     f"{ckpt}")
                    red["cut"] = dp_train("redecoder", "cuda", f"{d}/red_dp", RED_DP_STEPS,
                                          save_freq=1)
                    red["resumed"] = dp_train("redecoder", "cuda", f"{d}/red_dp",
                                              RED_DP_STEPS)
                finally:
                    if torch.distributed.is_initialized():
                        torch.distributed.destroy_process_group()
            runs["plain again"] = dp_train("codec", "cuda", f"{d}/plain_again", DP_STEPS)
    finally:
        undo()
        shutil.rmtree(d, ignore_errors=True)
    if sorted(runs["resumed"]["step_ms"]) != list(range(DP_CUT, DP_STEPS + 1)):
        raise AssertionError(f"14a: the resumed run stepped {sorted(runs['resumed']['step_ms'])}")
    _same_run("14a resumed data-parallel run against the plain run", runs["resumed"],
              runs["plain"])
    _same_run("14a plain runs", runs["plain again"], runs["plain"])
    for key, run in runs.items():
        dp = key in ("cut", "resumed")
        per = _per_step(run)
        if (per["f32"], per["vq"]) != (24, 6) or bool(run["reduced"][0]) != dp:
            raise AssertionError(f"14a {key}: launches a step {per}, reduces {run['reduced']}")
    bytes_step = runs["resumed"]["reduced"][1] // len(runs["resumed"]["step_ms"])
    warm = {k: [t for s, t in sorted(r["step_ms"].items()) if s != min(r["step_ms"])]
            for k, r in runs.items()}
    dp_ms = warm["cut"] + warm["resumed"]
    plain_ms = warm["plain"] + warm["plain again"]
    log(f"  resumed from the step-{DP_CUT - 1} checkpoint (rank 0's) to step {DP_STEPS}: "
        f"parameters and metrics bit-equal to the plain runs'; launches a step "
        f"{_per_step(runs['resumed'])}; the all-reduce ms a step {[round(t, 2) for t in reduce_ms]}"
        f" over {bytes_step} bytes ({bytes_step / 2**30:.3f} GiB, "
        f"{runs['resumed']['reduced'][0] // len(runs['resumed']['step_ms'])} calls)")
    log("  step ms in turns (host clock, each run's first step left out): "
        + "; ".join(f"{k} {[round(t, 1) for t in v]}" for k, v in warm.items())
        + f"; median data-parallel {statistics.median(dp_ms):.1f}, plain "
        f"{statistics.median(plain_ms):.1f} [{smi}]")
    out = {"a": dict(dp_ms=statistics.median(dp_ms), plain_ms=statistics.median(plain_ms),
                     reduce_ms=statistics.median(reduce_ms), reduce_bytes=bytes_step,
                     launches=_per_step(runs["resumed"]), world=world)}

    log(f"phase 14c: run_redecoder_training(fields=FLAGSHIP_REDECODER_TRAIN) the same way: "
        f"plain {RED_DP_STEPS} steps, data-parallel over NCCL cut at {RED_DP_STEPS} with a "
        f"checkpoint at step 1, resumed from it [{smi}]")
    if sorted(red["resumed"]["step_ms"]) != [RED_DP_STEPS]:
        raise AssertionError(f"14c: the resumed run stepped {sorted(red['resumed']['step_ms'])}")
    _same_run("14c resumed data-parallel run against the plain run", red["resumed"], red["plain"])
    if not (red["cut"]["reduced"][0] and red["resumed"]["reduced"][0]) or red["plain"]["reduced"][0]:
        raise AssertionError(f"14c: reduces {[r['reduced'] for r in red.values()]}")
    per = _per_step(red["cut"])
    if (per["f32"], per["vq"]) != (24, 6):
        raise AssertionError(f"14c: launches a step {per}")
    log(f"  parameters and metrics bit-equal; {red['cut']['reduced'][0] // RED_DP_STEPS} "
        f"all-reduce calls a step; launches a step {per}; step ms data-parallel "
        f"{[round(t, 1) for t in red['cut']['step_ms'].values()]}, plain "
        f"{[round(t, 1) for t in red['plain']['step_ms'].values()]} [{smi}]")
    out["c"] = dict(launches=per)
    return out


def _grad_gaps(got: dict, want: dict) -> dict:
    gaps = {}
    for mod, grads in want.items():
        pairs = [(a, b) for a, b in zip(got[mod], grads) if b is not None]
        scale = max(float(b.abs().max()) for _, b in pairs)
        gaps[mod] = max(float((a - b).abs().max()) for a, b in pairs) / scale
    return gaps


def dp_ranks(smi: str, world: int, device: str, backend, title: str, tp: bool = False) -> dict:
    """`world` spawned ranks (`dp_rank`), each running `run_training` on its
    TRAIN_BATCH / world rows of every batch, fused (2 steps, a checkpoint at
    step 1's epoch end) and split (1 step), against the same runs in this
    process alone. With `tp` the same ranks then run both again at
    `tensor_parallel=TP_MODEL` for 17a (`phase_tp`), which gets their
    results, their directory (the fused run's checkpoint) and the
    one-process runs."""
    variants = {"fused": dict(max_steps=2, save_freq=1),
                "split": dict(max_steps=1, split_step=True)}
    log(f"{title}: run_training(fields=FLAGSHIP_TRAIN) in each rank, {TRAIN_BATCH // world} rows "
        f"each of every {TRAIN_BATCH} x {TRAIN_FRAMES} batch, draws on, fused (2 steps, rank 0 "
        f"writes a checkpoint at step 1) and split (1 step), against the same runs in one "
        f"process; the last step's gradients within {DP_GRAD_TOL} of max|g| per module, metrics "
        f"and parameters rtol {DP_STEP_TOL['rtol']} atol {DP_STEP_TOL['atol']} [{smi}]")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    d = tempfile.mkdtemp(prefix="dp_ranks_", dir=build.BUILD_DIR)
    runs = [dict(log_dir=os.path.join(d, k), args=v) for k, v in variants.items()]
    if tp:
        runs += [dict(log_dir=os.path.join(d, "tp " + k), args=v, tp=True)
                 for k, v in variants.items()]
    try:
        spec = dict(device=device, backend=backend, out=d, runs=runs)
        torch.save(spec, os.path.join(d, "spec.pt"))
        t0 = time.perf_counter()
        ranks.spawn_ranks(world, ["-c", "import sys, chip_smoke; chip_smoke.dp_rank(sys.argv[1])",
                                  os.path.join(d, "spec.pt")], timeout=900)
        spawn_s = time.perf_counter() - t0
        ckpt = latest_checkpoint(os.path.join(d, "fused"))
        if not (ckpt or "").endswith("_step_00001.pth"):
            raise AssertionError(f"{title}: rank 0's checkpoint {ckpt}")
        got = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
               for r in range(world)]
    except BaseException:
        shutil.rmtree(d, ignore_errors=True)
        raise
    if not tp:
        shutil.rmtree(d, ignore_errors=True)
    out = {"spawn_s": spawn_s, "one": {}}
    if tp:
        out["tp"] = dict(dir=d, results={label: [g[len(variants) + i] for g in got]
                                         for i, label in enumerate(variants)})
    for i, (label, args) in enumerate(variants.items()):
        one = dp_train("codec", "cuda", os.path.join(build.BUILD_DIR, "dp_one"), record_grads=True,
                       **dict(args, save_freq=NO_SAVE))
        out["one"][label] = one  # 17a holds the tensor-parallel runs to the same runs
        shutil.rmtree(os.path.join(build.BUILD_DIR, "dp_one"), ignore_errors=True)
        res = [g[i] for g in got]
        n = TRAIN_BATCH // world
        for r, rr in enumerate(res):
            for (glob_lens, mine), (want_lens, _) in zip(rr["rows"], one["rows"]):
                if glob_lens != want_lens or mine != glob_lens[r * n:(r + 1) * n]:
                    raise AssertionError(f"{title} {label}: rank {r} kept {mine} of {glob_lens}")
        gaps = _grad_gaps(res[0]["grads"], one["grads"])
        log(f"  {label}: each rank kept its {n} rows of the batch's wave_lens "
            f"{one['rows'][-1][0]}; gradient gap of max|g| "
            + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()))
        for mod, gap in gaps.items():
            if not gap <= DP_GRAD_TOL:
                raise AssertionError(f"{title} {label}: {mod} gradient gap {gap:.3e} > "
                                     f"{DP_GRAD_TOL}")
        _same_on_ranks(f"{title} {label}", res)
        worst = 0.0
        for k, v in one["metrics"].items():
            g = res[0]["metrics"][k]
            worst = max(worst, abs(g - v) / max(abs(v), 1e-30))
            if not abs(g - v) <= DP_STEP_TOL["atol"] + DP_STEP_TOL["rtol"] * abs(v):
                raise AssertionError(f"{title} {label}: {k} {g} vs {v}")
        for k, v in one["params"].items():
            torch.testing.assert_close(res[0]["params"][k], v, msg=f"{title} {label}: {k}",
                                       **DP_STEP_TOL)
        per = [_per_step(rr) for rr in res]
        if any(p != _per_step(one) for p in per):
            raise AssertionError(f"{title} {label}: launches a step {per}, one process "
                                 f"{_per_step(one)}")
        steps = len(one["step_ms"])
        last = _step_collectives(res[0], steps) if backend == "gloo" else {}
        log(f"  {label}: metrics within {worst:.2e} relative; each rank's launches a step "
            f"{per[0]} as the one process's; rank step ms "
            f"{[[round(t, 1) for t in rr['step_ms'].values()] for rr in res]} "
            f"({res[0]['reduced'][0] // steps} all-reduce calls, {res[0]['reduced'][1] // steps} "
            f"bytes a step), one process {[round(t, 1) for t in one['step_ms'].values()]}"
            + (f"; the last step's collectives (calls, host ms) {_format_collectives(last)}"
               if last else "") + f" [{smi}]")
        out[label] = dict(gaps=gaps, launches=per[0],
                          rank_ms=[rr["step_ms"][steps] for rr in res],
                          one_ms=one["step_ms"][steps], reduced=res[0]["reduced"],
                          collectives=last)
    log(f"  spawn, build and the runs in the ranks {spawn_s:.1f} s"
        + (" (17a's tensor-parallel runs included)" if tp else ""))
    return out


def _in_turns(fns: dict, turns: int = SHARD_TURNS) -> dict:
    """Median ms of each fn, called in turns (a, b, b, a, ...)."""
    times = {k: [] for k in fns}
    keys = list(fns)
    for i in range(turns):
        for k in (keys if i % 2 == 0 else keys[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[k]()
            torch.cuda.synchronize()
            times[k].append(1e3 * (time.perf_counter() - t0))
    return {k: statistics.median(v) for k, v in times.items()}


def phase_shard(smi: str) -> tuple:
    """14d: shard_inference of FLAGSHIP (float32 and hybrid) and
    FLAGSHIP_REDECODER at batch 3 x 10 s, over every visible GPU and over
    two replicas on cuda:0, against the unsharded calls."""
    w = sweep_wave(SHARD_BATCH, SECONDS, seed=30)
    codec = FACodec.from_fields(FLAGSHIP, seed=0, device="cuda")
    red = FARedecoder.from_fields(FLAGSHIP_REDECODER, seed=1, device="cuda")
    mods = (codec.encoder, codec.quantizer, codec.decoder)
    plain = {p: FACodec(*mods, precision=p) for p in ("float32", "hybrid")}
    vc = FACodec(*mods, n_c=1)
    f = plain["float32"].encode(w)
    f1 = vc.encode(w)
    want = {p: c.reconstruct(w) for p, c in plain.items()}
    want_vc = red.resynthesize(f1, f.timbre)
    layouts = {"every GPU": None, "2 on cuda:0": ["cuda:0", "cuda:0"]}
    out = {}
    for name, devices in layouts.items():
        n = len(devices) if devices else torch.cuda.device_count()
        log(f"phase 14d: shard_inference over {name} ({n} replicas), batch {SHARD_BATCH} x "
            f"{SECONDS:.0f} s: reconstruct float32 and hybrid, encode, resynthesize [{smi}]")
        sharded = {p: FACodec(*mods, precision=p).shard_inference(devices) for p in plain}
        sred = FARedecoder(red.encoder, red.decoder).shard_inference(devices)
        try:
            got_f = sharded["float32"].encode(w)
            for k in ("codes_p", "codes_c", "codes_r"):
                if not np.array_equal(getattr(got_f, k), getattr(f, k)):
                    raise AssertionError(f"14d {name}: {k} differ from the unsharded encode's")
            timbre_gap = float(np.abs(got_f.timbre - f.timbre).max())
            if not timbre_gap <= SHARD_F32_TOL:
                raise AssertionError(f"14d {name}: the timbre differs from the unsharded one by "
                                     f"{timbre_gap:.3e}")
            counts, gaps, same_gaps, ms = {}, {}, {}, {}
            per = -(-SHARD_BATCH // n)
            padded = np.concatenate([w, np.zeros((per * n - SHARD_BATCH, w.shape[1]),
                                                 np.float32)])
            for p, c in sharded.items():
                reset_counts()
                got = c.reconstruct(w)
                counts[p] = {k: v / n for k, v in all_counts().items()}
                # the unsharded codec on each replica's rows: the same batches
                same = np.concatenate([plain[p].reconstruct(padded[i * per:(i + 1) * per])
                                       for i in range(n)])[:SHARD_BATCH]
                same_gaps[p] = float(np.abs(got - same).max() / np.abs(same).max())
                if p == "float32":
                    gaps[p] = float(np.abs(got - want[p]).max())
                    ok = gaps[p] <= SHARD_F32_TOL
                else:
                    gaps[p] = float(np.abs(got - want[p]).max() / np.abs(want[p]).max())
                    ok = gaps[p] <= HYBRID_BF16
                if not (ok and same_gaps[p] <= SHARD_HYBRID_TOL):
                    raise AssertionError(f"14d {name} {p}: gap {gaps[p]:.3e} to the unsharded "
                                         f"call, {same_gaps[p]:.3e} to it on each replica's rows")
                ms[p] = _in_turns({"unsharded": lambda c=plain[p]: c.reconstruct(w),
                                   "sharded": lambda c=c: c.reconstruct(w)})
            got_vc = sred.resynthesize(f1, f.timbre)
            vc_gap = float(np.abs(got_vc - want_vc).max())
            if not vc_gap <= SHARD_F32_TOL:
                raise AssertionError(f"14d {name}: resynthesize gap {vc_gap:.3e}")
            ms["vc"] = _in_turns({"unsharded": lambda: red.resynthesize(f1, f.timbre),
                                  "sharded": lambda: sred.resynthesize(f1, f.timbre)})
        finally:
            for c in (*sharded.values(), sred):
                c.replicas.close()
        expect = {"float32": dict(f32=24, bf16=0, halo=0, vq=6),
                  "hybrid": dict(f32=12, bf16=12, halo=0, vq=6)}
        for p, c in counts.items():
            if c != expect[p]:
                raise AssertionError(f"14d {name} {p}: launches per replica {c}, "
                                     f"expected {expect[p]}")
        log(f"  codes equal, timbre max abs {timbre_gap:.2e}; against the unsharded call on all "
            f"rows: float32 max abs {gaps['float32']:.2e} (limit {SHARD_F32_TOL}), hybrid "
            f"err/scale {gaps['hybrid']:.2e} (limit {HYBRID_BF16}); against it on each replica's "
            f"rows, err/scale: float32 {same_gaps['float32']:.2e}, hybrid "
            f"{same_gaps['hybrid']:.2e} (limit {SHARD_HYBRID_TOL}); resynthesize max abs "
            f"{vc_gap:.2e}; launches per replica {counts}")
        log("  ms unsharded / sharded, in turns: " + "; ".join(
            f"{k} {v['unsharded']:.1f} / {v['sharded']:.1f}" for k, v in ms.items())
            + f" [{smi}]")
        out[name] = dict(replicas=n, gaps=gaps, same_gaps=same_gaps, vc_gap=vc_gap,
                         timbre_gap=timbre_gap, launches=counts, ms=ms)
    return out, plain["hybrid"]


def phase_shard_serve(codec_hy: FACodec, smi: str) -> dict:
    """14e: CodecService over two hybrid replicas on cuda:0 against one
    unsharded service of the same batch cap: 8 concurrent 10 s requests to
    each, in turns (unsharded, sharded, sharded, unsharded)."""
    n_req = 8
    sharded_codec = FACodec(codec_hy.encoder, codec_hy.quantizer, codec_hy.decoder,
                            precision="hybrid").shard_inference(["cuda:0", "cuda:0"])
    services = {"unsharded": serve_cli.CodecService(codec_hy, max_batch=n_req,
                                                    batch_window_ms=200.0),
                "sharded": serve_cli.CodecService(sharded_codec, max_batch=n_req,
                                                  batch_window_ms=200.0)}
    servers = {k: serve_cli.make_server(s, "127.0.0.1", 0) for k, s in services.items()}
    for s in servers.values():
        threading.Thread(target=s.serve_forever, daemon=True).start()
    bases = {k: f"http://127.0.0.1:{s.server_address[1]}" for k, s in servers.items()}
    log(f"phase 14e: serve --shard-inference semantics, two hybrid replicas on cuda:0 against "
        f"one unsharded service, max batch {n_req}; {n_req} concurrent {SECONDS:.0f} s "
        f"/reconstruct requests to each, in turns [{smi}]")
    try:
        blobs = [serve_cli.write_wav_bytes(x) for x in sweep_wave(n_req, SECONDS, seed=40)]
        for base in bases.values():
            _http("POST", f"{base}/reconstruct", blobs[0])  # warm up
        rps = {k: [] for k in bases}
        outs = {}
        for k in ("unsharded", "sharded", "sharded", "unsharded"):
            r, outs[k] = _concurrent_rps(bases[k], blobs)
            rps[k].append(r)
        gaps = [float(np.abs(a - b).max() / np.abs(b).max())
                for a, b in zip(outs["sharded"], outs["unsharded"])]
        if not max(gaps) <= HYBRID_BF16:  # 4 + 4 rows against 8: another batch's decode
            raise AssertionError(f"14e: sharded responses differ by err/scale {max(gaps):.3e}")
        health = json.loads(_http("GET", f"{bases['sharded']}/health"))
        log(f"  responses within err/scale {max(gaps):.2e} of the unsharded service's (limit "
            f"{HYBRID_BF16}); requests/s unsharded {[round(r, 2) for r in rps['unsharded']]}"
            f", sharded {[round(r, 2) for r in rps['sharded']]}; sharded device calls "
            f"{health['device_calls']}, largest batch {health['max_batch_seen']} [{smi}]")
        return dict(rps=rps, gap=max(gaps))
    finally:
        for s in servers.values():
            s.shutdown()
            s.server_close()
        for s in services.values():
            s.close()
        sharded_codec.replicas.close()


def phase_dp(smi: str) -> dict:
    """Phase 14: training and serving over several GPUs."""
    t0 = time.perf_counter()
    nccl = phase_dp_nccl(smi)
    world = nccl["a"]["world"]
    if world > 1:
        nccl["ranks"] = dp_ranks(smi, world, "cuda", None,
                                 f"phase 14a: {world} NCCL ranks, one per GPU")
    t1 = time.perf_counter()
    gloo = dp_ranks(smi, 2, "cuda:0", "gloo", "phase 14b: 2 gloo ranks on cuda:0 (NCCL refuses "
                    "two ranks on one card; the same ranks then run 17a's tensor-parallel runs)",
                    tp=True)
    t2 = time.perf_counter()
    shard, codec_hy = phase_shard(smi)
    t3 = time.perf_counter()
    sv = phase_shard_serve(codec_hy, smi)
    log(f"phase 14: 14a+14c {t1 - t0:.1f} s, 14b {t2 - t1:.1f} s, 14d {t3 - t2:.1f} s, 14e "
        f"{time.perf_counter() - t3:.1f} s")
    del codec_hy
    torch.cuda.empty_cache()
    return dict(nccl=nccl, gloo=gloo, shard=shard, serve=sv)


# ---------------------------------------------------------------- phase 15
POLICY_GRAPH_LAUNCHES = 50  # phase 15's CUDA graphs: 30 units' shapes inside its time
INT8_OPS = 1979e12  # int8 tensor-core peak, operations/s
CODE_SHARE_MIN = 0.9  # bfloat16 codes equal to float32's (the JAX package saw 96.67%)


# the kernels' launches of one flagship round trip under each policy
POLICY_LAUNCHES = {"float32": dict(f32=24, vq=6), "hybrid": dict(f32=12, bf16=12, vq=6),
                   "bfloat16": dict(f32io=24, vq=6),
                   "hybrid_int8": dict(f32=12, amax=3, int8=3, act=3, bf16=6, vq=6)}


def policy_counts() -> dict:
    f = resunit.fused_residual_unit
    out = {k: getattr(f, attr) for k, attr in POLICY_COUNTERS.items()}
    return dict(out, halo=resunit.fused_residual_unit_stream.launches, vq=vq.nearest_code.launches)


def f32io_unit_cost(B: int, T: int, C: int) -> tuple:
    """(FLOP, bytes) of a float32-in/out unit: 16 C^2 FLOP a row; x read and
    out written in float32; the pack read once (bf16 weights, float32
    biases, alphas and reciprocals)."""
    return 16 * B * T * C * C, 8 * B * T * C + 2 * 8 * C * C + 4 * 6 * C


def int8_unit_cost(B: int, T: int, C: int) -> tuple:
    """(int8 operations, bf16 FLOP, bytes) of the int8 unit: 14 C^2 int8
    operations (the conv7) and 2 C^2 FLOP (the 1x1) a row; x read twice
    (row maxima, unit) and out written in float32; the pack once (int8 w7,
    bf16 w1 and b1, float32 scales, b7, alphas, reciprocals)."""
    return (14 * B * T * C * C, 2 * B * T * C * C,
            12 * B * T * C + 7 * C * C + 2 * C * C + 2 * C + 4 * 6 * C)


def phase_policy_units(calls: list, route: str, title: str) -> dict:
    """15a / 15b: each captured unit input through its kernel form and the
    plain version under the form's policy."""
    log(title)
    pol = {"f32io": "bfloat16", "f32io_act": "bfloat16_act", "int8": "int8"}[route]
    tot = dict(ms=0.0, wrapper_ms=0.0, plain_ms=0.0, bound_ms=0.0, flops=0, int8_ops=0)
    if route == "int8":
        tot.update(unit_ms=0.0, amax_ms=0.0)
    bound_of = {"operations": 0.0, "bytes": 0.0}
    worst_abs = worst_ulps = 0.0
    for unit, x in calls:
        d, causal = unit.dilation, unit.causal
        B, T, C = x.shape
        x = x.contiguous()
        if x.dtype != torch.float32:
            raise AssertionError(f"{route} unit input is {x.dtype}, expected float32")
        w = unit._operands()
        args = (x, *w, d, causal)
        pl, ext = resunit.reflect_extent(T, d, causal)
        out = torch.empty_like(x)
        with torch.no_grad(), float32_exact():
            pack = unit.kept_pack(x, route)  # kept by the round trip that gave x
            if pack is None:
                raise AssertionError("the unit keeps no packed operands")
            got = resunit.run_packed(route, x, pack, d, causal)
            extra = ""
            if route == "int8":
                amax = resunit.int8_row_amax_reference(x, w[4])
                parts = resunit.int8_unit_parts(x, amax, pack, d, causal)
                want = parts["out"]
                c7 = torch.empty_like(x)
                q1 = torch.empty(B, T + 6 * d, C, dtype=torch.int8, device=x.device)
                k_amax = resunit.launch_int8_amax(x, pack.alpha1, pack.recip1)
                resunit.launch_int8(x, k_amax, pack, d, pl, ext, out, c7=c7, q1=q1)
                torch.cuda.synchronize()
                if not (torch.equal(k_amax, amax) and torch.equal(q1, parts["q1"])
                        and torch.equal(c7, parts["c7"])):
                    raise AssertionError(f"int8 unit {tuple(x.shape)} d={d}: row maxima, q1 or "
                                         f"c7 differ from the plain version's")
                if not torch.equal(out, got):
                    raise AssertionError("the int8 unit differs between two launches")
                extra = "; row maxima, q1 and c7 bit-equal"
                del parts, c7, q1

                def launch():
                    resunit.launch_int8_amax(x, pack.alpha1, pack.recip1, amax)
                    resunit.launch_int8(x, amax, pack, d, pl, ext, out)
                amax_ms = device_ms(lambda: resunit.launch_int8_amax(x, pack.alpha1, pack.recip1,
                                                                     amax), POLICY_GRAPH_LAUNCHES)
                # the unit alone and its share of its bound (operations)
                unit_ms = device_ms(lambda: resunit.launch_int8(x, amax, pack, d, pl, ext, out),
                                    POLICY_GRAPH_LAUNCHES)
                ops, flop, _ = int8_unit_cost(B, T, C)
                unit_bound = 1e3 * (ops / INT8_OPS + flop / BF16_FLOPS)
                tot["unit_ms"] += unit_ms
                tot["amax_ms"] += amax_ms
                log(f"  int8 unit alone d={d}: {unit_ms:.4f} ms ({unit_bound / unit_ms:.1%} of its "
                    f"{unit_bound:.4f} ms bound)")
                extra += f"; row maxima alone {amax_ms:.4f} ms"
                plain = lambda: resunit.residual_unit_int8_reference(*args)  # noqa: E731
            else:
                want = resunit.residual_unit_reference(*args, pol)
                act = route == "f32io_act"

                def launch():
                    resunit.launch_f32io(x, pack, d, pl, ext, act, out)
                plain = lambda: resunit.residual_unit_reference(*args, pol)  # noqa: E731
            scale = resunit.bf16_error_scale(*args, route)
            torch.cuda.synchronize()
            ulps = resunit.bf16_ulps(got, want, scale).max().item()
            err = (got - want).abs().max().item()
            equal = (got == want).float().mean().item()
            del want, scale
            if got.dtype != torch.float32 or not ulps <= BF16_MAX_ULPS:
                raise AssertionError(f"{route} unit {tuple(x.shape)} d={d}: {got.dtype}, {ulps} "
                                     f"ulps > {BF16_MAX_ULPS}")
            del got
            tk = device_ms(launch, POLICY_GRAPH_LAUNCHES)
            with policy(pol):
                tw = median_ms(lambda: resunit.fused_residual_unit(*args))
            tp = median_ms(plain)
        if route == "int8":
            ops, flop, nbytes = int8_unit_cost(B, T, C)
            t_ops = ops / INT8_OPS + flop / BF16_FLOPS
            tot["int8_ops"] += ops
        else:
            flop, nbytes = f32io_unit_cost(B, T, C)
            t_ops = flop / BF16_FLOPS
        b = 1e3 * max(t_ops, nbytes / HBM_BYTES_S)
        by = "operations" if t_ops > nbytes / HBM_BYTES_S else "bytes"
        bound_of[by] += b
        worst_abs, worst_ulps = max(worst_abs, err), max(worst_ulps, ulps)
        for k, v in (("ms", tk), ("wrapper_ms", tw), ("plain_ms", tp), ("bound_ms", b),
                     ("flops", flop)):
            tot[k] += v
        log(f"  B={B} C={C:4d} T={T:6d} d={d}: bound {b:.4f} ms ({by}); kernel {tk:.4f} ms "
            f"({b / tk:.1%} of the bound), wrapper {tw:.4f} ms, plain {tp:.4f} ms; "
            f"{equal:.4%} bit-equal, worst {ulps:.2f} ulps, max abs {err:.3e}{extra}")
    by_all = max(bound_of, key=bound_of.get)
    if route == "int8":
        log(f"  {len(calls)} units: the unit alone {tot['unit_ms']:.4f} ms, the row maxima "
            f"{tot['amax_ms']:.4f} ms")
    log(f"  {len(calls)} units: kernel {tot['ms']:.3f} ms ({tot['bound_ms'] / tot['ms']:.1%} of the "
        f"{tot['bound_ms']:.3f} ms bound, {by_all}), wrapper {tot['wrapper_ms']:.3f} ms, plain "
        f"{tot['plain_ms']:.3f} ms")
    return dict(max_abs_err=worst_abs, max_ulps=worst_ulps, bound_by=by_all, **tot)


def _code_share(a, b) -> float:
    names = ("codes_p", "codes_c", "codes_r")
    same = sum(int((getattr(a, n) == getattr(b, n)).sum()) for n in names)
    return same / sum(getattr(a, n).size for n in names)


def phase_policies(codec: FACodec, codec_hy: FACodec, cpu: FACodec, w: np.ndarray,
                   smi: str) -> dict:
    from facodec_tpu_torch.ops.metrics import si_sdr

    t_phase = time.perf_counter()
    B = w.shape[0]
    log(f"phase 15: precision policies bfloat16 and hybrid_int8, flagship, batch {B} x "
        f"{SECONDS:.0f} s [{smi}]")
    codec_bf = FACodec(codec.encoder, codec.quantizer, codec.decoder, precision="bfloat16")
    codec_i8 = FACodec(codec.encoder, codec.quantizer, codec.decoder, precision="hybrid_int8")
    f32 = codec.encode(w)
    units_bf = unit_inputs((codec.encoder, codec.decoder),
                           lambda: codec_bf.decode(codec_bf.encode(w)), 24)
    units_i8 = unit_inputs((codec.decoder,), lambda: codec_i8.decode(f32), 12)
    k1 = phase_policy_units(units_bf, "f32io", "phase 15a: the bfloat16 form of the bf16 kernel "
                            "(float32 in and out) vs plain on the 24 units of a bfloat16 round "
                            "trip; <= 2 bf16 ulps")
    act_calls = [(u, x) for u, x in units_i8 if x.dtype == torch.float32 and x.shape[-1] == 384]
    int8_calls = [(u, x) for u, x in units_i8 if x.shape[-1] == 768]
    if len(act_calls) != 3 or len(int8_calls) != 3:
        raise AssertionError(f"hybrid_int8 decode: {len(act_calls)} float32 C=384 units, "
                             f"{len(int8_calls)} C=768 units, expected 3 and 3")
    k1a = phase_policy_units(act_calls, "f32io_act", "phase 15a: the act form (float32 in and "
                             "out, the bf16 entry's rounding) vs plain on the 3 C=384 units of a "
                             "hybrid_int8 decode; <= 2 bf16 ulps")
    k2 = phase_policy_units(int8_calls, "int8", "phase 15b: the int8 unit (row maxima + unit) "
                            "vs plain on the 3 C=768 units of a hybrid_int8 decode")
    del units_bf, units_i8, act_calls, int8_calls
    torch.cuda.empty_cache()

    log("phase 15c: round trips in turns (float32, hybrid, bfloat16, hybrid_int8, then "
        "reversed), encode -> decode")
    codecs = {"float32": codec, "hybrid": codec_hy, "bfloat16": codec_bf, "hybrid_int8": codec_i8}
    times = {p: [] for p in codecs}
    files, waves, launches = {}, {}, {}
    for p in (*codecs, *reversed(codecs)):
        c = codecs[p]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        f = c.encode(w)
        y = c.decode(f)
        torch.cuda.synchronize()
        times[p].append(time.perf_counter() - t0)
        n = {k: v for k, v in policy_counts().items() if v}
        want = POLICY_LAUNCHES[p]
        if n != want:
            raise AssertionError(f"{p} round trip launched {n}, expected {want}")
        launches[p] = n
        files[p], waves[p] = f, y
    for p in codecs:
        y = waves[p]
        if y.dtype != np.float32 or y.shape != (B, int(SR * SECONDS)) or not np.isfinite(y).all():
            raise AssertionError(f"{p} wave {y.dtype} {y.shape} is not a finite float32 wave")
    share = _code_share(files["bfloat16"], files["float32"])
    i8_share = _code_share(files["hybrid_int8"], files["float32"])
    if share < CODE_SHARE_MIN:
        raise AssertionError(f"bfloat16 codes equal to float32's: {share} < {CODE_SHARE_MIN}")
    if i8_share != 1.0 or not np.array_equal(files["hybrid_int8"].timbre, files["float32"].timbre):
        raise AssertionError("hybrid_int8 codes or timbre differ from float32's (its encode is "
                             "float32)")
    sdr = {p: [float(si_sdr(waves[p][i], waves["float32"][i])) for i in range(B)]
           for p in ("hybrid", "bfloat16", "hybrid_int8")}
    log(f"  times (s, in turns): " + "; ".join(f"{p} {', '.join(f'{t:.3f}' for t in v)}"
                                             for p, v in times.items()))
    log(f"  launches: {launches}")
    log(f"  bfloat16 codes equal to float32's: {share:.4%}; hybrid_int8: {i8_share:.4%} "
        f"(timbre equal)")
    log("  SI-SDR against the float32 wave (dB, per row): "
        + "; ".join(f"{p} {[round(v, 2) for v in r]}" for p, r in sdr.items()))

    wc = sweep_wave(1, 2.0, seed=3)
    f = codec.encode(wc)
    gaps = {}
    for p, c in codecs.items():
        c_cpu = FACodec(cpu.encoder, cpu.quantizer, cpu.decoder, precision=p)
        t0 = time.perf_counter()
        y_cpu = c_cpu.decode(f)
        gaps[p] = check_hybrid_gap(f"{p} decode card vs CPU, batch 1 x 2 s, equal codes "
                                   f"(CPU {time.perf_counter() - t0:.1f} s)", c.decode(f), y_cpu)
    log(f"  phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return dict(k1=k1, k1a=k1a, k2=k2, times=times, launches=launches, bf16_code_share=share,
                si_sdr_db=sdr, cpu_gaps=gaps)


# ---------------------------------------------------------------- phase 16
BENCH_BATCH, BENCH_SECONDS = 16, 10.0  # the bench's headline shape
BENCH_POLICIES = ("hybrid_int8", "float32", "hybrid")  # 16a: the headline, then the others
BENCH_REPEATS = 1  # 16a: runs of bench.ITERS calls a policy (the bench's 3 cut for time)
BENCH_STREAM_SECONDS = 2.0  # 16b
# 16d: a traced round trip's device launches by residual-unit form (the I/O
# form of resunit_bf16_kernel is its last template argument: 0 the bf16
# entry, 1 the act form) and VQ kernel (two a search)
TRACED_LAUNCHES = {"hybrid": dict(f32=12, bf16=12, act=0, amax=0, int8=0, vq=12),
                   "hybrid_int8": dict(f32=12, bf16=6, act=3, amax=3, int8=3, vq=12)}


def _bf16_io_form(name: str) -> int:
    m = re.search(r"resunit_bf16_kernel<([^<>]*)>", name)
    if m is None:
        raise AssertionError(f"16d: no template arguments in the kernel name {name!r}")
    return int(m.group(1).split(",")[-1])


def traced_forms(count: dict) -> dict:
    """Launches by residual-unit form and VQ kernel, from a trace's kernel
    names and counts."""
    out = dict(f32=0, bf16=0, act=0, amax=0, int8=0, vq=0)
    for name, n in count.items():
        kind = kind_of(name)
        if kind == RESUNIT_F32:
            out["f32"] += n
        elif kind == RESUNIT_BF16:
            out["act" if _bf16_io_form(name) == 1 else "bf16"] += n
        elif kind == RESUNIT_INT8:
            out["amax" if "resunit_int8_amax" in name else "int8"] += n
        elif kind == PROFILE_VQ:
            out["vq"] += n
    return out


def phase_bench(codec: FACodec, smi: str) -> dict:
    """16a-c: the three bench commands as a user runs them (their `main`),
    each with the kernels' counts set to 0 before it and read after it;
    16d: a traced hybrid and hybrid_int8 round trip through
    utils/profiling.py, by kind, form and annotated range."""
    from facodec_tpu_torch import bench, bench_streaming, bench_train

    t_phase = time.perf_counter()
    calls = 1 + BENCH_REPEATS * bench.ITERS
    log(f"phase 16a: bench --fast (encode_decode_rtf, FACodec.reconstruct_tensor) under "
        f"{', '.join(BENCH_POLICIES)}, batch {BENCH_BATCH} x {BENCH_SECONDS:.0f} s, "
        f"{calls} round trips each; 0 < mfu <= 1 [{smi}]")
    lines, launches = {}, {}
    repeats, bench.REPEATS = bench.REPEATS, BENCH_REPEATS
    try:
        for p in BENCH_POLICIES:
            reset_counts()
            lines[p] = bench.main(batch=BENCH_BATCH, seconds=BENCH_SECONDS, precision=p,
                                  fast=True)
            launches[p] = {k: v for k, v in policy_counts().items() if v}
    finally:
        bench.REPEATS = repeats
    for p, line in lines.items():
        n = launches[p]
        want = {k: v * calls for k, v in POLICY_LAUNCHES[p].items()}
        if n != want:
            raise AssertionError(f"16a {p}: the bench launched {n}, expected {want}")
        if not 0 < line["mfu"] <= 1 or line["precision"] != p:
            raise AssertionError(f"16a {p}: {line}")
        launches[p] = POLICY_LAUNCHES[p]
    log("  rtf " + ", ".join(f"{p} {v['value']}x (mfu {v['mfu']})" for p, v in lines.items())
        + f"; launches a round trip {launches}")

    log(f"phase 16b: bench streaming --fast (streaming_chunk_p50_ms), batch 1 x "
        f"{BENCH_STREAM_SECONDS:.0f} s of 4-frame chunks, the causal redecoder, a group of 8 "
        f"[{smi}]")
    reset_counts()
    stream = bench_streaming.main(seconds=BENCH_STREAM_SECONDS, fast=True)
    n = policy_counts()
    if not (n["halo"] and n["vq"]) or n["f32"] or stream["device_op_ms"] is None:
        raise AssertionError(f"16b: launches {n}, device_op_ms {stream['device_op_ms']}")
    log(f"  launches {n}")

    log(f"phase 16c: bench train --fast (train_step_ms), FLAGSHIP_TRAIN batch {TRAIN_BATCH} x "
        f"{TRAIN_FRAMES} frames, 4 steps [{smi}]")
    reset_counts()
    train = bench_train.main(batch=TRAIN_BATCH, seg_frames=TRAIN_FRAMES, fast=True)
    n = {k: v for k, v in policy_counts().items() if v}
    if n != dict(f32=24 * 4, vq=6 * 4) or not train["value"] > 0:
        raise AssertionError(f"16c: 4 steps launched {n}, expected 24 and 6 a step")
    log(f"  launches {n}")

    log(f"phase 16d: traced round trips (utils.profiling.trace, aggregate_device_trace), "
        f"hybrid and hybrid_int8, batch {BATCH} x {SECONDS:.0f} s [{smi}]")
    wt = torch.from_numpy(sweep_wave(BATCH, SECONDS)).cuda()
    profiles = {}
    for p, want in TRACED_LAUNCHES.items():
        c = bench.with_policy(codec, p)
        c.reconstruct_tensor(wt)
        reset_counts()
        prof = round_trip_profile(c, wt)
        wrapped = {k: v for k, v in policy_counts().items() if v}
        log(f"  {p}:")
        print_breakdown(prof["by_kind"], prof["by_name"], prof["count"], prof["traced_wall_ms"])
        total = sum(prof["by_kind"].values())
        for title, key in (("range", "by_range"), ("range and kind", "by_range_kind")):
            log(f"  by annotated {title}: " + ", ".join(
                f"{k} {v:.2f} ms ({v / total:.1%})"
                for k, v in sorted(prof[key].items(), key=lambda kv: -kv[1])[:10]))
        lost = [name for name in prof["count"] if ("resunit" in name or "vq_" in name)
                and kind_of(name) == "other"]
        got = traced_forms(prof["count"])
        w8a8 = sum(n for name, n in prof["count"].items() if kind_of(name) == W8A8_KIND)
        log(f"  launches by form (trace) {got}; the wrappers' counts {wrapped}; W8A8 GEMMs "
            f"{w8a8}")
        if lost or got != want or wrapped != POLICY_LAUNCHES[p]:
            raise AssertionError(f"16d {p}: kernels of kind 'other' {lost}, launches {got} "
                                 f"(expected {want}), wrappers {wrapped}")
        if (w8a8 > 0) != (p == "hybrid_int8"):
            raise AssertionError(f"16d {p}: {w8a8} launches of kind {W8A8_KIND!r}")
        profiles[p] = dict(by_kind=dict(prof["by_kind"]), by_range=prof["by_range"],
                           launches=got, w8a8=w8a8, traced_wall_ms=prof["traced_wall_ms"])
    log(f"  phase 16 took {time.perf_counter() - t_phase:.1f} s")
    return dict(lines=lines, launches=launches, stream=stream, train=train, profiles=profiles)


# ---------------------------------------------------------------- phase 17
TP_MODEL = 2  # 17a: two gloo ranks on cuda:0 as data 1 x model 2
VALIDATE_SECONDS = 2.0  # 17b: the validate command's default chirp
# 17b: the reference-schema config of FLAGSHIP (scripts/emit_golden_flagship.py
# FLAGSHIP_CFG_TEXT) as JSON: the card machine has no pyyaml
VALIDATE_CONFIG = dict(preprocess_params=dict(sr=SR), model_params=dict(
    causal=True, lstm=2, norm_f0=True, use_gr_content_f0=False, use_gr_prosody_phone=False,
    use_gr_timbre_prosody=False, separate_prosody_encoder=True, n_c_codebooks=2,
    timbre_norm=True, use_gr_content_global_f0=True,
    DAC=dict(encoder_dim=64, encoder_rates=[2, 5, 5, 6], decoder_dim=1536,
             decoder_rates=[6, 5, 5, 2], sr=SR)))
WEBUI_LSB = 33  # 17c: int16 card vs CPU, DECODE_MAX_DIFF of full scale (1e-3 x 32767)
WEBUI_SECONDS, WEBUI_VC_SECONDS, WEBUI_SR = 10.0, 3.0, 16000
WEBUI_TURNS = 2  # timed calls of each handler on the card, after one warm-up


def _time_collectives(records: list):
    """In a gloo rank: each all-reduce and all-gather timed on
    the host clock between two synchronises, recorded as (step, kind, ms)
    where `step` counts the train steps' calls (None outside a step) and
    kind names the collective and its group ("model" or "world"). Returns
    undo."""
    from facodec_tpu_torch.train import loop as loop_mod

    dist = torch.distributed
    orig = dict(all_reduce=dist.all_reduce, all_gather=dist.all_gather)
    makers = {n: getattr(loop_mod, n) for n in ("make_codec_train_step",
                                                "make_codec_train_step_split")}
    where = {"step": None, "n": 0}

    def timed(name):
        fn = orig[name]

        def call(*args, group=None, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, group=group, **kwargs)
            torch.cuda.synchronize()
            lay = mesh.layout()
            kind = "model" if lay is not None and group is lay.model_group else "world"
            records.append((where["step"], f"{name} {kind}", 1e3 * (time.perf_counter() - t0)))
            return out
        return call

    def counted(make):
        def made(*args, **kwargs):
            fn = make(*args, **kwargs)

            def step(*a, **k):
                where["n"] += 1
                where["step"] = where["n"]
                try:
                    return fn(*a, **k)
                finally:
                    where["step"] = None
            return step
        return made

    for name in orig:
        setattr(dist, name, timed(name))
    for name, make in makers.items():
        setattr(loop_mod, name, counted(make))

    def undo():
        for name, fn in orig.items():
            setattr(dist, name, fn)
        for name, make in makers.items():
            setattr(loop_mod, name, make)

    return undo


def _step_collectives(run: dict, step: int) -> dict:
    """{kind: (calls, host ms)} of one step's timed collectives."""
    out = {}
    for s, kind, ms in run["collectives"]:
        if s == step:
            calls, total = out.get(kind, (0, 0.0))
            out[kind] = (calls + 1, total + ms)
    return out


def _format_collectives(step: dict) -> str:
    return ", ".join(f"{k} {c} {t:.1f}" for k, (c, t) in sorted(step.items()))


def _check_against(label: str, got: dict, want: dict, grads: bool = True) -> tuple:
    """(gradient gaps of max|g| per module, worst metric's relative gap) of
    a run against the one-process run, within DP_GRAD_TOL and DP_STEP_TOL."""
    gaps = _grad_gaps(got["grads"], want["grads"]) if grads else {}
    for mod, gap in gaps.items():
        if not gap <= DP_GRAD_TOL:
            raise AssertionError(f"{label}: {mod} gradient gap {gap:.3e} > {DP_GRAD_TOL}")
    worst = 0.0
    for k, v in want["metrics"].items():
        g = got["metrics"][k]
        worst = max(worst, abs(g - v) / max(abs(v), 1e-30))
        if not abs(g - v) <= DP_STEP_TOL["atol"] + DP_STEP_TOL["rtol"] * abs(v):
            raise AssertionError(f"{label}: {k} {g} vs {v}")
    for k, v in want["params"].items():
        torch.testing.assert_close(got["params"][k], v, msg=f"{label}: {k}", **DP_STEP_TOL)
    return gaps, worst


def phase_tp(smi: str, gloo: dict) -> dict:
    """17a: 14b's two gloo ranks on cuda:0 ran `run_training(fields=
    FLAGSHIP_TRAIN, tensor_parallel=2)` (data 1 x model 2: the wide heads'
    rows split over the two ranks) after their data-parallel runs, fused
    (2 steps, a checkpoint at step 1) and split (1 step); they are held to
    14b's one-process runs of the same calls. Then one process resumes the
    tensor-parallel run's step-1 checkpoint to step 2, against the
    one-process fused run."""
    log(f"phase 17a: run_training(fields=FLAGSHIP_TRAIN, tensor_parallel={TP_MODEL}) in 14b's 2 "
        f"gloo ranks on cuda:0 (data 1 x model {TP_MODEL}: the wide heads' rows split), every "
        f"{TRAIN_BATCH} x {TRAIN_FRAMES} batch whole on each, draws on, fused (2 steps, rank 0 "
        f"writes a checkpoint at step 1) and split (1 step), against 14b's one-process runs; the "
        f"last step's gradients within {DP_GRAD_TOL} of max|g| per module, metrics and gathered "
        f"parameters rtol {DP_STEP_TOL['rtol']} atol {DP_STEP_TOL['atol']}; each collective "
        f"timed between two synchronises [{smi}]")
    d, one_runs = gloo["tp"]["dir"], gloo["one"]
    try:
        fused_dir = os.path.join(d, "tp fused")
        firsts = [p for p in os.listdir(fused_dir) if p.endswith("_step_00001.pth")]
        if not firsts:
            raise AssertionError(f"17a: rank 0 wrote {os.listdir(fused_dir)}")
        ckpt = torch.load(os.path.join(fused_dir, firsts[0]), weights_only=True, mmap=True)
        head = ckpt["net"]["fa_predictors"]["timbre_predictor.weight"].shape
        mu = ckpt["optimizer"]["fa_predictors"]["mu"]["timbre_predictor.weight"].shape
        if head != (20000, 1024) or mu != head:
            raise AssertionError(f"17a: the checkpoint's speaker head {head}, its moment {mu}")
        del ckpt
        # the run stopped at step 2 inside its epoch: step 1's is its latest checkpoint
        resumed = dp_train("codec", "cuda", fused_dir, 2, record_grads=True)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    out = {}
    for label, res in gloo["tp"]["results"].items():
        one = one_runs[label]
        if res[0]["sharded"] != res[1]["sharded"] or len(res[0]["sharded"]) != 7:
            raise AssertionError(f"17a {label}: sharded {res[0]['sharded']}")
        for r, rr in enumerate(res):
            for glob_lens, mine in rr["rows"]:
                if mine != glob_lens:
                    raise AssertionError(f"17a {label}: rank {r} kept {mine} of {glob_lens}")
        gaps, worst = _check_against(f"17a {label}", res[0], one)
        _same_on_ranks(f"17a {label}", res)
        per = [_per_step(rr) for rr in res]
        if any(p != _per_step(one) for p in per):
            raise AssertionError(f"17a {label}: launches a step {per}, one process "
                                 f"{_per_step(one)}")
        if any(v for k, v in per[0].items() if k not in ("f32", "vq")):
            raise AssertionError(f"17a {label}: a float32 step launched {per[0]}")
        steps = len(one["step_ms"])
        last = _step_collectives(res[0], steps)
        pb, sb = res[0]["param_bytes"], res[0]["sharded_bytes"]
        log(f"  {label}: gradient gap of max|g| " + ", ".join(f"{k} {v:.2e}" for k, v in
                                                             gaps.items())
            + f"; metrics within {worst:.2e} relative; sharded {res[0]['sharded']}")
        log(f"  {label}: rank step ms {[[round(t, 1) for t in rr['step_ms'].values()] for rr in res]}"
            f", one process {[round(t, 1) for t in one['step_ms'].values()]}; launches a step "
            f"{per[0]} on each rank, as the one process's; rank 0 holds {sb[0]} of {sb[1]} bytes of "
            f"the sharded tensors (x3 with the AdamW moments: {3 * sb[0]} of {3 * sb[1]}), "
            f"{3 * pb[0]} of {3 * pb[1]} bytes of parameters and moments in all; the last step's "
            f"collectives (calls, host ms) " + _format_collectives(last)
            + f"; model-group sums and gathers {res[0]['model'][0]} calls, {res[0]['model'][1]} "
            f"bytes, all-reduces {res[0]['reduced'][0]} calls, {res[0]['reduced'][1]} bytes in "
            f"the run [{smi}]")
        out[label] = dict(gaps=gaps, launches=per[0],
                          rank_ms=[rr["step_ms"][steps] for rr in res],
                          one_ms=one["step_ms"][steps], collectives=last,
                          sharded_bytes=sb, param_bytes=pb)
    if sorted(resumed["step_ms"]) != [2]:
        raise AssertionError(f"17a: the resumed run stepped {sorted(resumed['step_ms'])}")
    gaps, worst = _check_against("17a resumed", resumed, one_runs["fused"])
    log(f"  one process resumed the tensor-parallel run's step-1 checkpoint (whole tensors) to "
        f"step 2: gradient gap of max|g| " + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items())
        + f", metrics within {worst:.2e} relative of the one-process fused run")
    return out


def phase_validate(cpu: FACodec, smi: str) -> dict:
    """17b: `python -m facodec_tpu_torch validate` (its `main`) on the card
    at FLAGSHIP width: a seeded checkpoint in the reference's layout (one
    state dict per module) and a golden that the port computes from it on
    the CPU (its codes, timbre and reconstruction of the command's chirp)."""
    from facodec_tpu_torch import api
    from facodec_tpu_torch.cli import validate
    from facodec_tpu_torch.models.builder import codec_fields

    fields = codec_fields(VALIDATE_CONFIG["model_params"])
    if fields != {k: dict(FLAGSHIP[k], **{f: v for f, v in fields[k].items()
                                          if f not in FLAGSHIP[k]}) for k in fields}:
        raise AssertionError(f"17b: the config builds {fields}, not FLAGSHIP")
    log(f"phase 17b: validate --golden on the card, FLAGSHIP (seed 0) from a checkpoint in the "
        f"reference's layout, the golden from the port on the CPU; the {VALIDATE_SECONDS:.0f} s "
        f"chirp; codes >= {CODE_MATCH_MIN} equal to the golden's, mel_l1 within the threshold "
        f"[{smi}]")
    d = tempfile.mkdtemp(prefix="validate_", dir=build.BUILD_DIR)
    try:
        ckpt = os.path.join(d, "pytorch_model.bin")
        torch.save({k: getattr(cpu, k).state_dict() for k in ("encoder", "quantizer", "decoder")},
                   ckpt)
        config = os.path.join(d, "config.json")
        with open(config, "w") as f:
            json.dump(VALIDATE_CONFIG, f)
        wave = validate._test_wave("", VALIDATE_SECONDS)
        t0 = time.perf_counter()
        g = cpu.encode(wave[None])
        golden = os.path.join(d, "golden.npz")
        np.savez(golden, codes_p=g.codes_p, codes_c=g.codes_c, codes_r=g.codes_r,
                 timbre=g.timbre, recon=cpu.reconstruct(wave[None]))
        golden_s = time.perf_counter() - t0
        seen = []
        encode = api.FACodec.encode
        api.FACodec.encode = lambda self, w: seen.append(encode(self, w)) or seen[-1]
        parser = __import__("argparse").ArgumentParser()
        validate.add_args(parser)
        args = parser.parse_args(["--ckpt", ckpt, "--config", config, "--golden", golden,
                                  "--seconds", str(VALIDATE_SECONDS), "--device", "cuda"])
        buf = __import__("io").StringIO()
        reset_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                rc = validate.main(args)
        finally:
            api.FACodec.encode = encode
        torch.cuda.synchronize()
        validate_s = time.perf_counter() - t0
        counts = policy_counts()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    line = buf.getvalue().strip().splitlines()[-1]
    out = json.loads(line)
    names = ("codes_p", "codes_c", "codes_r")
    same = sum(int((np.asarray(getattr(seen[0], n)) == np.asarray(getattr(g, n))).sum())
               for n in names)
    total = sum(getattr(g, n).size for n in names)
    log(f"  {line}")
    log(f"  exit code {rc}; codes equal to the golden's {same}/{total} ({same / total:.5f}); "
        f"launches {counts}; the command {validate_s:.1f} s (the build from the checkpoint "
        f"included), the golden on the CPU {golden_s:.1f} s [{smi}]")
    if same / total < CODE_MATCH_MIN:
        raise AssertionError(f"17b: codes {same / total} < {CODE_MATCH_MIN}")
    if not out["mel_l1"] <= out["mel_l1_threshold"]:
        raise AssertionError(f"17b: mel_l1 {out['mel_l1']} > {out['mel_l1_threshold']}")
    if rc != (0 if out["pass"] else 1) or not (counts["f32"] and counts["vq"]):
        raise AssertionError(f"17b: exit code {rc} for {out}, launches {counts}")
    return dict(line=out, rc=rc, code_share=same / total, launches=counts, s=validate_s)


def _pcm16(seconds: float, sr: int, seed: int) -> np.ndarray:
    """A seeded speech-like int16 clip (a gliding tone with noise)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    w = 0.3 * np.sin(2 * np.pi * (140 + 30 * seed + 20 * np.sin(2 * np.pi * 0.5 * t)) * t)
    return ((w + 0.02 * rng.standard_normal(len(t))) * 32767).astype(np.int16)


def phase_webui(cpu: FACodec, smi: str) -> dict:
    """17c: the webui handlers (`webui.make_handlers`) at FLAGSHIP width on
    the card against the same handlers on the CPU: `do_reconstruct` on
    10 s of int16 at 16 kHz (resampled to 24 kHz), `do_convert` on two 3 s
    int16 clips."""
    from facodec_tpu_torch import webui

    log(f"phase 17c: webui handlers, FLAGSHIP (seed 0) and FLAGSHIP_REDECODER (seed 1): "
        f"do_reconstruct on {WEBUI_SECONDS:.0f} s of int16 at {WEBUI_SR} Hz, do_convert on two "
        f"{WEBUI_VC_SECONDS:.0f} s int16 clips, card against CPU within {WEBUI_LSB} LSB; "
        f"{WEBUI_TURNS} timed calls each after a warm-up [{smi}]")
    card = webui.make_handlers(FACodec.from_fields(FLAGSHIP, seed=0, device="cuda"),
                               FARedecoder.from_fields(FLAGSHIP_REDECODER, seed=1, device="cuda"))
    host = webui.make_handlers(cpu, FARedecoder.from_fields(FLAGSHIP_REDECODER, seed=1,
                                                            device="cpu"))
    rec_in = (WEBUI_SR, _pcm16(WEBUI_SECONDS, WEBUI_SR, 1))
    vc_in = ((SR, _pcm16(WEBUI_VC_SECONDS, SR, 2)), (SR, _pcm16(WEBUI_VC_SECONDS, SR, 3)))
    out = {}
    for name, i, args in (("reconstruct", 0, (rec_in,)), ("convert", 1, vc_in)):
        fn = card[i]
        fn(*args)
        reset_counts()
        got = fn(*args)
        counts = policy_counts()
        times = []
        for _ in range(WEBUI_TURNS):
            t0 = time.perf_counter()
            fn(*args)
            times.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        want = host[i](*args)
        cpu_ms = 1e3 * (time.perf_counter() - t0)
        if got[0] != want[0] or got[1].dtype != np.int16 or got[1].shape != want[1].shape:
            raise AssertionError(f"17c {name}: {got[0]} {got[1].dtype} {got[1].shape} against "
                                 f"{want[0]} {want[1].shape}")
        lsb = int(np.abs(got[1].astype(np.int32) - want[1].astype(np.int32)).max())
        log(f"  do_{name}: {got[1].shape[0]} samples at {got[0]} Hz, card vs CPU max {lsb} LSB; "
            f"card ms {[round(t, 1) for t in times]} (host clock, the handler's call), CPU "
            f"{cpu_ms:.0f} ms; launches {counts} [{smi}]")
        if lsb > WEBUI_LSB or not (counts["f32"] and counts["vq"]):
            raise AssertionError(f"17c {name}: {lsb} LSB, launches {counts}")
        out[name] = dict(lsb=lsb, ms=times, cpu_ms=cpu_ms, launches=counts)
    return out


def phase_entry_points(smi: str, gloo: dict) -> dict:
    """Phase 17: the entry points the slice ports (tensor-parallel
    training, validate, the webui handlers); `gloo` is 14b's result."""
    t0 = time.perf_counter()
    tp = phase_tp(smi, gloo)
    t1 = time.perf_counter()
    cpu = FACodec.from_fields(FLAGSHIP, seed=0, device="cpu")
    va = phase_validate(cpu, smi)
    t2 = time.perf_counter()
    ui = phase_webui(cpu, smi)
    log(f"phase 17: 17a {t1 - t0:.1f} s, 17b {t2 - t1:.1f} s, 17c "
        f"{time.perf_counter() - t2:.1f} s")
    del cpu
    torch.cuda.empty_cache()
    return dict(tp=tp, validate=va, webui=ui)


# ---------------------------------------------------------------- phase 18
LSTM_INT8_TOL = dict(y=1e-3, hT=1e-3, cT=2e-3)  # 18a: the kernel against its plain version
STREAM_LSTM_TOL = 1e-5  # 18c: the decoder LSTM in 4-frame chunks against one shot
LSTM_CHUNK = 4  # 18c: frames a chunk (50 ms)
INT8_OPS = 1979e12  # dense int8 tensor-core peak of one H100 SXM
LSTM_POLICIES = ("hybrid", "hybrid_int8")


@contextlib.contextmanager
def lstm_int8_flag(on: bool):
    """FACODEC_LSTM_INT8 set to 1 or 0 inside the block, then restored: the
    flag is process-wide, and every phase but 18 runs without it."""
    old = os.environ.get("FACODEC_LSTM_INT8")
    os.environ["FACODEC_LSTM_INT8"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("FACODEC_LSTM_INT8", None)
        else:
            os.environ["FACODEC_LSTM_INT8"] = old


class _LayerCalls:
    """Stands in for `ops.kernels.lstm` inside nn/lstm.py: records the
    operands of each `lstm_int8` call and passes it on (its launches are
    counted as ever)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(klstm, name)

    def lstm_int8(self, *args):
        self.calls.append(args)
        return klstm.lstm_int8(*args)


def decoder_lstm_calls(codec: FACodec, f) -> tuple:
    """(the decoder SLSTM's input, each layer's `lstm_int8` operands) in one
    flagged decode of f."""
    m = decoder_slstm(codec)
    seen, rec = [], _LayerCalls()
    hook = m.register_forward_pre_hook(lambda mod, args: seen.append(args[0]))
    nn_lstm.lstm_kernel = rec
    try:
        with lstm_int8_flag(True):
            codec.decode(f)
    finally:
        nn_lstm.lstm_kernel = klstm
        hook.remove()
    return seen[0], rec.calls


def decoder_slstm(codec: FACodec) -> SLSTM:
    (m,) = [m for m in codec.decoder.modules() if isinstance(m, SLSTM)]
    return m


def lstm_int8_cost(B: int, T: int, H: int) -> tuple:
    """(int8 operations, bytes) of one layer: 2 B T 4H H; x_proj, w_q, its
    scales, h0 and c0 read once, y, hT and cT written once."""
    return (2 * B * T * 4 * H * H,
            4 * B * T * 4 * H + 4 * H * H + 4 * 4 * H + 4 * 2 * B * H + 4 * (B * T * H + 2 * B * H))


def phase_lstm_int8(codec: FACodec, cpu: FACodec, smi: str) -> dict:
    """Phase 18: the opt-in W8A8 LSTM recurrence (FACODEC_LSTM_INT8=1 inside
    this phase only) on the flagship decoder's SLSTM (H = 1536, 2 layers)."""
    t_phase = time.perf_counter()
    if klstm.lstm_int8.launches:
        raise AssertionError(f"the W8A8 LSTM kernel launched {klstm.lstm_int8.launches} times "
                             f"before phase 18, where the flag is off")
    if "FACODEC_LSTM_INT8_MIN_BYTES" in os.environ:
        raise AssertionError("phase 18 runs at the default FACODEC_LSTM_INT8_MIN_BYTES")
    w = sweep_wave(BATCH, SECONDS)
    codecs = {p: FACodec(codec.encoder, codec.quantizer, codec.decoder, precision=p)
              for p in LSTM_POLICIES}
    m = decoder_slstm(codec)
    f32 = codec.encode(w)
    x, calls = decoder_lstm_calls(codecs["hybrid"], f32)
    B, T, H = x.shape[0], x.shape[1], m.lstm.hidden_size
    dev = x.device

    log(f"phase 18a: the W8A8 LSTM kernel (csrc/lstm_int8.cu) vs plain on the decoder's {len(calls)} "
        f"layers of one hybrid decode, B={B} T={T} H={H}; y, hT within {LSTM_INT8_TOL['y']}, cT "
        f"within {LSTM_INT8_TOL['cT']}; bound at {INT8_OPS / 1e12:.0f} int8 TOPS or "
        f"{HBM_BYTES_S / 1e12:.2f} TB/s [{smi}]")
    plan = klstm.plan(B, H, dev)
    log(f"  launch shape {plan}")
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops=0, floor_ms=0.0)
    worst = 0.0
    for k, args in enumerate(calls):
        with torch.no_grad():
            got = klstm.lstm_int8(*args)
            want = klstm.lstm_int8_reference(*args)
            torch.cuda.synchronize()
        errs = {n: float((a - b).abs().max()) for n, a, b in zip(("y", "hT", "cT"), got, want)}
        equal = float((got[0] == want[0]).float().mean())
        for n, e in errs.items():
            if not e <= LSTM_INT8_TOL[n]:
                raise AssertionError(f"18a layer {k}: {n} off by {e} > {LSTM_INT8_TOL[n]}")
        worst = max(worst, *errs.values())
        tk = median_ms(lambda: klstm.lstm_int8(*args))
        tp = median_ms(lambda: klstm.lstm_int8_reference(*args), repeats=1)
        barrier_ms = median_ms(lambda: klstm.barriers(B, H, T, dev), repeats=3) / T
        ops, nbytes = lstm_int8_cost(B, T, H)
        bound = 1e3 * max(ops / INT8_OPS, nbytes / HBM_BYTES_S)
        by = "operations" if ops / INT8_OPS >= nbytes / HBM_BYTES_S else "bytes"
        floor = T * barrier_ms
        for key, v in (("ms", tk), ("plain_ms", tp), ("bound_ms", bound), ("ops", ops),
                       ("floor_ms", floor)):
            tot[key] += v
        log(f"  layer {k}: max|x_proj| {args[0].abs().max().item():.3e}; errors {errs}, y "
            f"bit-equal {equal:.4%}; kernel {tk:.3f} ms ({tk / T * 1e3:.2f} us a step), plain "
            f"{tp:.2f} ms; {ops:.4e} int8 operations, {nbytes} bytes: bound {bound:.4f} ms "
            f"({by}), {bound / tk:.2%} of it reached; one grid barrier {barrier_ms * 1e3:.3f} us, "
            f"so a serial floor of {floor:.3f} ms ({floor / tk:.1%} of the kernel)")
    n_layers = len(calls)
    del calls

    log(f"phase 18b: hybrid and hybrid_int8 round trips, batch {BATCH} x {SECONDS:.0f} s, "
        f"without and with the flag [{smi}]")
    cudnn_ms = None
    out = dict(decoder_lstm_ms={}, decode_ms={}, gap={}, launches={})
    wc = sweep_wave(1, 2.0, seed=3)
    for p, c in codecs.items():
        runs = {}
        for on in (False, True):
            with lstm_int8_flag(on):
                reset_counts()
                klstm.lstm_int8.launches = 0
                f = c.encode(w)
                y = c.decode(f)
                torch.cuda.synchronize()
                runs[on] = (f, y, dict(policy_counts(), lstm=klstm.lstm_int8.launches))
        (f0, y0, n0), (f1, y1, n1) = runs[False], runs[True]
        log(f"  {p}: launches without the flag {n0}, with it {n1}")
        if n0["lstm"] != 0 or n1["lstm"] != 2:
            raise AssertionError(f"18b {p}: the decode launched the W8A8 LSTM {n0['lstm']} times "
                                 f"without the flag, {n1['lstm']} with it (expected 0 and 2)")
        if {k: v for k, v in n0.items() if k != "lstm"} != {k: v for k, v in n1.items()
                                                           if k != "lstm"}:
            raise AssertionError(f"18b {p}: the flag changed the other kernels' launches")
        for name in ("codes_p", "codes_c", "codes_r", "timbre"):
            if not np.array_equal(getattr(f0, name), getattr(f1, name)):
                raise AssertionError(f"18b {p}: {name} differ with the flag (the encode is "
                                     f"float32)")
        worst_w, rms_w = wave_gap(y1, y0)
        if not np.isfinite(y1).all() or y1.shape != y0.shape:
            raise AssertionError(f"18b {p}: the flagged wave is not finite or not {y0.shape}")
        xin = [None]
        hook = m.register_forward_pre_hook(lambda mod, args: xin.__setitem__(0, args[0]))
        c.decode(f1)
        hook.remove()
        lstm_ms, dec_ms = {}, {False: [], True: []}
        with torch.no_grad(), float32_exact(), policy(c.dec_policy):
            for on in (False, True):
                with lstm_int8_flag(on):
                    lstm_ms[on] = median_ms(lambda: m(xin[0]))
        for on in (False, True, True, False):
            with lstm_int8_flag(on):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                c.decode(f1)
                torch.cuda.synchronize()
                dec_ms[on].append(1e3 * (time.perf_counter() - t0))
        if p == "hybrid":
            cudnn_ms = lstm_ms[False]
        log(f"  {p}: codes and timbre equal with and without the flag; flagged wave against "
            f"the flagless: err/scale {worst_w:.3e} at the worst sample, {rms_w:.3e} in RMS; "
            f"the decoder LSTM (device, median) {lstm_ms[False]:.3f} ms flagless (cuDNN) -> "
            f"{lstm_ms[True]:.3f} ms flagged (projections + kernel); the decode (host clock, in "
            f"turns off, on, on, off) {[round(t, 2) for t in dec_ms[False]]} ms flagless, "
            f"{[round(t, 2) for t in dec_ms[True]]} ms flagged [{smi}]")
        if p == "hybrid":  # the card against the CPU, once: the kernel is the same under both
            cpu_p = FACodec(cpu.encoder, cpu.quantizer, cpu.decoder, precision=p)
            fc = c.encode(wc)
            with lstm_int8_flag(True):
                before = klstm.lstm_int8.launches
                y_gpu = c.decode(fc)
                y_cpu = cpu_p.decode(fc)
                if klstm.lstm_int8.launches != before + 2:
                    raise AssertionError(f"18b {p}: the card's 1 x 2 s decode did not launch "
                                         f"twice")
            out["card_cpu"] = check_hybrid_gap(f"{p} flagged decode card vs CPU, batch 1 x 2 s",
                                               y_gpu, y_cpu)
        out["decoder_lstm_ms"][p] = {"flagless": lstm_ms[False], "flagged": lstm_ms[True]}
        out["decode_ms"][p] = {"flagless": dec_ms[False], "flagged": dec_ms[True]}
        out["gap"][p] = dict(worst=worst_w, rms=rms_w)
        out["launches"][p] = n1["lstm"]

    c = codecs["hybrid"]
    wt = torch.from_numpy(w).cuda()
    outs, codes_t, timbre_t = c.encode_tensor(wt)
    first = -(-min_first_frames_decoder(codec.decoder.rates) // LSTM_CHUNK) * LSTM_CHUNK
    log(f"phase 18c: a StreamingFACodec decode under bfloat16_act and the flag, batch {B} x "
        f"{SECONDS:.0f} s: a {first}-frame first chunk, then {LSTM_CHUNK}-frame chunks, against "
        f"the flagged one-shot hybrid decode of the same latent (phase 8's {HYBRID_VS_F32} "
        f"err/scale for decodes that round apart: the stream's residual units run float32, "
        f"the one-shot's bf16); the "
        f"decoder SLSTM's streamed output and final (h, c) against one shot on its streamed "
        f"input within {STREAM_LSTM_TOL} [{smi}]")
    sess = StreamingFACodec(codec.encoder, codec.quantizer, codec.decoder,
                            chunk_frames=LSTM_CHUNK, n_c=codec.n_c)
    xs, ys = [], []
    hooks = [m.register_forward_pre_hook(lambda mod, args: xs.append(args[0])),
             m.register_forward_hook(lambda mod, args, out: ys.append(out))]
    bounds = [0, *range(first, outs.shape[1], LSTM_CHUNK), outs.shape[1]]
    parts, per_chunk = [], []
    try:
        with lstm_int8_flag(True), policy("bfloat16_act"):
            st = sess.init_decode_state(B)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i, j in zip(bounds, bounds[1:]):
                before = klstm.lstm_int8.launches
                st, yc = sess.decode_chunk(st, outs[:, i:j])
                per_chunk.append(klstm.lstm_int8.launches - before)
                parts.append(yc)
            torch.cuda.synchronize()
            chunk_ms = 1e3 * (time.perf_counter() - t0) / len(parts)
    finally:
        for hk in hooks:
            hk.remove()
    y_stream = torch.cat(parts, 1).float().cpu().numpy()
    with lstm_int8_flag(True):
        y_one = c.decode_latent(outs).cpu().numpy()
        with torch.no_grad(), float32_exact(), policy("bfloat16_act"):
            y1, (h1, c1) = m(torch.cat(xs, 1), return_state=True)
    ys_cat, (hs_, cs_) = torch.cat([o[0] for o in ys], 1), ys[-1][1]
    n_chunks = len(parts)
    gaps = [float((a - b).abs().max()) for a, b in ((ys_cat, y1), (hs_, h1), (cs_, c1))]
    bit = all(torch.equal(a, b) for a, b in ((ys_cat, y1), (hs_, h1), (cs_, c1)))
    log(f"  {n_chunks} chunks, launches a chunk {sorted(set(per_chunk))}, {chunk_ms:.3f} ms a "
        f"chunk (host clock); the SLSTM streamed against one shot: y, h, c off by {gaps} "
        f"({'bit-equal' if bit else 'not bit-equal'})")
    if set(per_chunk) != {n_layers} or len(xs) != n_chunks:
        raise AssertionError(f"18c: launches a chunk {sorted(set(per_chunk))}, {len(xs)} SLSTM "
                             f"calls for {n_chunks} chunks (expected {n_layers} and one each)")
    if not max(gaps) <= STREAM_LSTM_TOL:
        raise AssertionError(f"18c: the SLSTM streamed vs one shot {gaps} > {STREAM_LSTM_TOL}")
    if y_stream.shape != y_one.shape or not np.isfinite(y_stream).all():
        raise AssertionError(f"18c: the streamed wave {y_stream.shape} against {y_one.shape}, "
                             f"or not finite")
    stream_wave = wave_gap(y_stream, y_one)
    log(f"  the streamed flagged decode against the one-shot: err/scale {stream_wave[0]:.3e} at "
        f"the worst sample (limit {HYBRID_VS_F32}), {stream_wave[1]:.3e} in RMS")
    if not stream_wave[0] <= HYBRID_VS_F32:
        raise AssertionError(f"18c: the streamed wave {stream_wave[0]} > {HYBRID_VS_F32}")
    del xs, ys, parts

    log(f"phase 18d: a traced hybrid_int8 round trip under the flag (profile.round_trip_profile), "
        f"batch {BATCH} x {SECONDS:.0f} s [{smi}]")
    wt = torch.from_numpy(w).cuda()
    with lstm_int8_flag(True):
        c = codecs["hybrid_int8"]
        c.reconstruct_tensor(wt)
        reset_counts()
        klstm.lstm_int8.launches = 0
        prof = round_trip_profile(c, wt)
        wrapped = dict({k: v for k, v in policy_counts().items() if v},
                       lstm=klstm.lstm_int8.launches)
    print_breakdown(prof["by_kind"], prof["by_name"], prof["count"], prof["traced_wall_ms"])
    total = sum(prof["by_kind"].values())
    log("  by annotated range and kind: " + ", ".join(
        f"{k} {v:.2f} ms ({v / total:.1%})"
        for k, v in sorted(prof["by_range_kind"].items(), key=lambda kv: -kv[1])[:10]))
    traced = sum(n for name, n in prof["count"].items() if kind_of(name) == LSTM_INT8_KIND)
    decode_cudnn = prof["by_range_kind"].get("decode: cuDNN LSTM", 0.0)
    log(f"  W8A8 LSTM launches {traced} (trace), {wrapped['lstm']} (wrapper); the wrappers' "
        f"counts {wrapped}; the decode's cuDNN LSTM {decode_cudnn:.3f} ms")
    if traced != 2 or wrapped["lstm"] != 2 or decode_cudnn:
        raise AssertionError(f"18d: {traced} traced and {wrapped['lstm']} wrapped launches of "
                             f"the W8A8 LSTM, the decode's cuDNN LSTM {decode_cudnn} ms")
    log(f"phase 18e: the flagged hybrid decode exported (utils/export.py export_codec with the "
        f"flag set, batch {B} x {SECONDS:.0f} s): {n_layers} facodec::lstm_int8 nodes, no "
        f"aten.lstm, {n_layers} launches a call with the flag unset, the wave against the live "
        f"flagged decode within phase 13's {ARTIFACT_HYBRID_TOL} err/scale [{smi}]")
    hy = codecs["hybrid"]
    tmp = tempfile.mkdtemp(prefix="facodec_lstm_int8_")
    try:
        with lstm_int8_flag(True):
            rep = export.export_codec(hy, tmp, batch=B, seconds=SECONDS, functions=("decode",))
        exp = export.ExportedCodec(tmp)
        nodes = collections.Counter(str(n.target) for n in exp.program("decode").graph.nodes
                                    if n.op == "call_function")
        with torch.no_grad():
            before = klstm.lstm_int8.launches
            y_art = exp.decode(export.codec_params(hy), *codes_t, timbre_t)
            torch.cuda.synchronize()
            n_art = klstm.lstm_int8.launches - before
            with lstm_int8_flag(True):
                y_live = hy.decode_tensor(*codes_t, timbre_t)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    export_s = rep["decode"]["seconds"]
    log(f"  exported in {export_s:.1f} s; op nodes {nodes['facodec.lstm_int8.default']}, "
        f"aten.lstm {nodes['aten.lstm.input']}; launches {n_art}")
    if (nodes["facodec.lstm_int8.default"], nodes["aten.lstm.input"], n_art) != (
            n_layers, 0, n_layers):
        raise AssertionError(f"18e: {nodes['facodec.lstm_int8.default']} op nodes, "
                             f"{nodes['aten.lstm.input']} aten.lstm, {n_art} launches")
    export_gap = check_artifact_wave("18e flagged hybrid decode", "hybrid", y_art, y_live)
    klstm.lstm_int8.launches = 0  # the phases after this one launch it no time
    log(f"  phase 18 took {time.perf_counter() - t_phase:.1f} s")
    return dict(max_abs_err=worst, bound_by=by, plan=plan, cudnn_lstm_ms=cudnn_ms,
                barrier_us=tot["floor_ms"] / n_layers / T * 1e3,
                serial_floor_ms=tot["floor_ms"], stream_gap=max(gaps), stream_bit_equal=bit,
                stream_launches=n_layers, stream_wave_gap=stream_wave[0], chunk_ms=chunk_ms,
                export_launches=n_art, export_gap=export_gap, export_s=export_s,
                profile=dict(by_kind=dict(prof["by_kind"]), by_range=prof["by_range"]),
                ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
                int8_ops=tot["ops"], **out)


# ---------------------------------------------------------------- phase 19
BF16_TRAIN = {"bfloat16": "f32io", "bfloat16_act": "bf16"}  # policy -> its units' kernel form
BF16_TRAIN_COUNTER = {"f32io": "f32io_launches", "bf16": "bf16_launches"}
BF16_STEP_TOL = 2e-2  # 19b: a bf16 step's losses, card against CPU, relative
BF16_STEPS = 4  # 19c: one warm-up step, three timed, per policy
BF16_UNIT_REPEATS = 5  # 19a: timed calls of each unit's forward and forward+backward


def bf16_train_unit_checks(units: list, precision: str, gen: torch.Generator) -> dict:
    """19a, one policy: each captured unit input through its bf16 kernel
    form with gradients (`fused_residual_unit` under the policy, packing per
    call as a training forward does) and through the plain composition's
    autograd on the float32 weights: one launch of the form and none of the
    float32 entry forward; the output within BF16_MAX_ULPS at
    `bf16_error_scale`; the gradients of x, both weights, both biases and
    both alphas within TRAIN_GRAD_TOL x max|g| (both under deterministic
    algorithms: the backward is the plain composition recomputed from the
    saved pack); forward and forward+backward times of both."""
    route = BF16_TRAIN[precision]
    counter = BF16_TRAIN_COUNTER[route]
    cost = bf16_unit_cost if route == "bf16" else f32io_unit_cost
    worst_ulps = worst_grad = 0.0
    tot = dict(fwd_ms=0.0, fwd_plain_ms=0.0, fwd_bwd_ms=0.0, fwd_bwd_plain_ms=0.0, flops=0,
               bound_ms=0.0)
    bound_of = {"operations": 0.0, "bytes": 0.0}
    for unit, x in units:
        snake1, conv7, snake2, conv1 = unit.block
        base = [t.detach().contiguous() for t in (
            x, conv7.effective_weight(), conv7.bias, conv1.effective_weight(), conv1.bias,
            snake1.alpha, snake2.alpha)]
        d, causal = unit.dilation, unit.causal
        cot = torch.randn(x.shape, device="cuda", generator=gen).to(x.dtype)

        def run(fn, backward=True):
            leaves = [t.clone().requires_grad_(backward) for t in base]
            y = fn(*leaves, d, causal)
            return y, (torch.autograd.grad(y, leaves, cot) if backward else None)

        with float32_exact(), policy(precision):
            with deterministic():
                before = (resunit.fused_residual_unit.launches,
                          getattr(resunit.fused_residual_unit, counter))
                got, g_kernel = run(resunit.fused_residual_unit)
                launched = (resunit.fused_residual_unit.launches - before[0],
                            getattr(resunit.fused_residual_unit, counter) - before[1])
                want, g_plain = run(resunit.residual_unit_reference)
            if launched != (0, 1):
                raise AssertionError(f"19a {precision}: the unit launched {launched} (float32 "
                                     f"entry, {route} form), expected (0, 1)")
            scale = resunit.bf16_error_scale(*base, d, causal, route)
            ulps = resunit.bf16_ulps(got, want, scale).max().item()
            if not ulps <= BF16_MAX_ULPS:
                raise AssertionError(f"19a {precision}: forward {ulps:.2f} bf16 ulps off plain")
            rel = {}
            for name, a, b in zip(UNIT_GRADS, g_kernel, g_plain):
                rel[name] = ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                if not rel[name] <= TRAIN_GRAD_TOL:
                    raise AssertionError(f"19a {precision} C={x.shape[-1]} d={d}: {name} "
                                         f"gradient {rel[name]:.3e} of max|g| off plain")
            with torch.no_grad():
                tk = median_ms(lambda: resunit.fused_residual_unit(*base, d, causal),
                               BF16_UNIT_REPEATS)
                tp = median_ms(lambda: resunit.residual_unit_reference(*base, d, causal),
                               BF16_UNIT_REPEATS)
            tkb = median_ms(lambda: run(resunit.fused_residual_unit), BF16_UNIT_REPEATS)
            tpb = median_ms(lambda: run(resunit.residual_unit_reference), BF16_UNIT_REPEATS)
        worst_ulps, worst_grad = max(worst_ulps, ulps), max(worst_grad, max(rel.values()))
        B, T, C = x.shape
        flop, nbytes = cost(B, T, C)
        b_ms = bound_ms(flop, nbytes, BF16_FLOPS)
        bound_of["operations" if flop / BF16_FLOPS >= nbytes / HBM_BYTES_S else "bytes"] += b_ms
        for k, v in (("fwd_ms", tk), ("fwd_plain_ms", tp), ("fwd_bwd_ms", tkb),
                     ("fwd_bwd_plain_ms", tpb), ("flops", flop), ("bound_ms", b_ms)):
            tot[k] += v
        log(f"  {precision} B={B} C={C:4d} T={T:6d} d={d}: forward {ulps:.2f} ulps, gradients "
            f"(of max|g|) " + " ".join(f"{k} {v:.1e}" for k, v in rel.items())
            + f"; forward kernel {tk:.3f} ms plain {tp:.3f} ms, forward+backward kernel "
            f"{tkb:.3f} ms plain {tpb:.3f} ms; bound {b_ms:.4f} ms")
    bound_by = max(bound_of, key=bound_of.get)
    log(f"  {precision}: {len(units)} units in the {route} form: forward kernel "
        f"{tot['fwd_ms']:.3f} ms plain {tot['fwd_plain_ms']:.3f} ms; forward+backward kernel "
        f"{tot['fwd_bwd_ms']:.3f} ms plain {tot['fwd_bwd_plain_ms']:.3f} ms (the backward "
        f"recomputes the plain composition); forward FLOP {tot['flops']:.4e}, bf16 bound "
        f"{tot['bound_ms']:.3f} ms ({bound_by}), share {tot['bound_ms'] / tot['fwd_ms']:.1%}; "
        f"worst forward {worst_ulps:.2f} ulps, worst gradient {worst_grad:.2e} of max|g|")
    return dict(tot, max_ulps=worst_ulps, grad_max_rel=worst_grad, bound_by=bound_by, route=route)


def phase_bf16_train_units(models: dict, batch: dict, smi: str) -> dict:
    """19a: the captured inputs of one FLAGSHIP_TRAIN training forward under
    each bf16 policy (24 units each), through the policy's kernel form (on
    10a's models and batch)."""
    log(f"phase 19a: the bf16 kernel forms with gradients on the inputs of one flagship training "
        f"forward (batch {TRAIN_BATCH} x {TRAIN_FRAMES} frames) under bfloat16 (the float32-in/"
        f"out form) and bfloat16_act (the bf16 entry): forward <= {BF16_MAX_ULPS} bf16 ulps, "
        f"gradients of {', '.join(UNIT_GRADS)} within {TRAIN_GRAD_TOL} x max|g| of plain "
        f"autograd; forward and forward+backward ms (median of {BF16_UNIT_REPEATS}); FLOP and "
        f"the bf16 bound ({BF16_FLOPS / 1e12:.0f} TFLOP/s, {HBM_BYTES_S / 1e12:.2f} TB/s) [{smi}]")
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for precision in BF16_TRAIN:
        units = []
        hooks = [m.register_forward_pre_hook(lambda mod, args: units.append((mod, args[0])))
                 for part in (models["encoder"], models["decoder"]) for m in part.modules()
                 if isinstance(m, ResidualUnit)]
        with float32_exact(), policy(precision):
            fwd = gen_forward(models, batch, torch.Generator(device="cuda").manual_seed(1))
        for h in hooks:
            h.remove()
        del fwd
        want_dtype = torch.bfloat16 if precision == "bfloat16_act" else torch.float32
        if len(units) != 24 or any(x.dtype != want_dtype for _, x in units):
            raise AssertionError(f"19a {precision}: {len(units)} unit inputs, dtypes "
                                 f"{sorted({str(x.dtype) for _, x in units})}")
        out[precision] = bf16_train_unit_checks(units, precision, gen)
        del units
    return out


def phase_bf16_train_steps(models: dict, smi: str) -> dict:
    """19c: steps of FLAGSHIP_TRAIN at TRAIN_BATCH x TRAIN_FRAMES under
    float32, bfloat16 and bfloat16_act from one seeded state (10a's models
    as they were built); per policy the launches a step, every loss finite,
    every module's parameters float32 and moved, step ms and peak memory,
    then one traced step by kind."""
    log(f"phase 19c: {BF16_STEPS} steps (1 warm-up) of FLAGSHIP_TRAIN at {TRAIN_BATCH} x "
        f"{TRAIN_FRAMES} frames under float32, bfloat16 and bfloat16_act (make_codec_train_step, "
        f"the fused step; one seeded state each); launches a step (24 residual units in the "
        f"policy's form, 0 in the float32 entry under bf16, 6 VQ), step ms (host clock until the "
        f"metrics are read), peak memory, one traced step [{smi}]")
    start = {k: {n: t.clone() for n, t in m.state_dict().items()} for k, m in models.items()}
    batch = train_batch(TRAIN_BATCH, TRAIN_FRAMES, 11, "cuda")
    audio_s = TRAIN_BATCH * TRAIN_FRAMES * HOP / SR
    out = {}
    for precision in ("float32", *BF16_TRAIN):
        for k, m in models.items():
            m.load_state_dict(start[k])
        step = make_codec_train_step(models, build_optimizers(models), precision=precision)
        gen = torch.Generator(device="cuda").manual_seed(5)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times = []
        reset_counts()
        for i in range(BF16_STEPS):
            t0 = time.perf_counter()
            metrics, _ = step(batch, gen)
            metrics = {k: float(v) for k, v in metrics.items()}
            times.append(1e3 * (time.perf_counter() - t0))
        peak = torch.cuda.max_memory_allocated()
        c = policy_counts()
        per_step = {k: v / BF16_STEPS for k, v in c.items() if v}
        form = BF16_TRAIN.get(precision, "f32")
        want = {form: 24, "vq": 6}
        if per_step != want:
            raise AssertionError(f"19c {precision}: launches a step {per_step}, expected {want}")
        for k, v in metrics.items():
            if not np.isfinite(v):
                raise AssertionError(f"19c {precision}: {k} = {v}")
        for name, m in models.items():
            params = list(m.parameters())
            moved = sum(not torch.equal(p, start[name][n]) for (n, _), p in
                        zip(m.named_parameters(), params))
            if moved == 0 or any(p.dtype != torch.float32 for p in params):
                raise AssertionError(f"19c {precision}: {name} moved {moved}, dtypes "
                                     f"{sorted({str(p.dtype) for p in params})}")
        step_ms = statistics.median(times[1:])
        prof = train_profile(step, batch, gen)
        kinds = {kind: prof["by_kind"].get(kind, 0.0) for kind in (RESUNIT_F32, RESUNIT_BF16,
                                                                   PROFILE_VQ)}
        log(f"  {precision}: step ms first {times[0]:.1f}, then "
            + ", ".join(f"{t:.1f}" for t in times[1:]) + f"; median {step_ms:.1f} ms, "
            f"{audio_s * 1e3 / step_ms:.2f} s of audio per s; peak memory {peak / 2**30:.2f} GiB "
            f"({(peak - base) / 2**30:.2f} GiB over the state); launches a step {per_step}; "
            f"loss/gen_all {metrics['loss/gen_all']:.6g}, loss/disc {metrics['loss/disc']:.6g}; "
            f"traced step: device ms of the residual units {kinds[RESUNIT_F32]:.2f} float32, "
            f"{kinds[RESUNIT_BF16]:.2f} bf16 forms, VQ {kinds[PROFILE_VQ]:.3f} [{smi}]")
        print_breakdown(prof["by_kind"], prof["by_name"], prof["count"], prof["traced_wall_ms"],
                        top=8)
        out[precision] = dict(step_ms=step_ms, times=times, peak_bytes=peak,
                              peak_over_state=peak - base, per_step=per_step, kernel_ms=kinds,
                              traced_wall_ms=prof["traced_wall_ms"])
        del step
    del start
    torch.cuda.empty_cache()
    return out


def phase_forward_v1(codec: FACodec, cpu: FACodec, w: np.ndarray, smi: str) -> dict:
    """19d: the legacy 4-stream quantizer (`timbre_norm=False`) at the
    flagship quantizer's width on the phase-3 codec's encoder latent of the
    batch of 4 x 10 s: `forward_v1` at n_c = 2 launches the VQ kernel 8
    times; `encode` and `decode` on the card against the CPU (codes
    >= CODE_MATCH_MIN equal, decode within DECODE_MAX_DIFF where the codes
    are equal)."""
    from facodec_tpu_torch.models.fa_quantizer import FAquantizer
    from facodec_tpu_torch.utils.weights import init_random_

    fields = dict(FLAGSHIP["quantizer"], timbre_norm=False)
    log(f"phase 19d: FAquantizer(timbre_norm=False) at the flagship width ({fields['in_dim']}, "
        f"codebooks {fields['codebook_size']} x {fields['codebook_dim']}, separate prosody "
        f"encoder {fields['separate_prosody_encoder']}), seed 0, on the flagship encoder's latent "
        f"of {BATCH} x {SECONDS:.0f} s: forward_v1 (n_c 2), encode, decode; card against CPU "
        f"[{smi}]")
    q_cpu = init_random_(FAquantizer(**fields), torch.Generator().manual_seed(0)).eval()
    q_card = FAquantizer(**fields)
    q_card.load_state_dict(q_cpu.state_dict())
    q_card = q_card.cuda().eval()
    wt = torch.from_numpy(w)
    with torch.no_grad(), float32_exact():
        z = codec.encoder(wt.cuda()[:, :, None])
        reset_counts()
        outs, quantized, commit, cb = q_card(z, wt.cuda(), n_c=2)
        torch.cuda.synchronize()
        launched = vq.nearest_code.launches
        if launched != 8 or not torch.isfinite(outs).all():
            raise AssertionError(f"19d: forward_v1 launched {launched} VQ searches (expected 8), "
                                 f"finite {bool(torch.isfinite(outs).all())}")
        t = {"forward_v1": median_ms(lambda: q_card(z, wt.cuda(), n_c=2), 3),
             "encode": median_ms(lambda: q_card.encode(z, wt.cuda(), n_c=2), 3)}
        codes, _ = q_card.encode(z, wt.cuda(), n_c=2)
        stacked = torch.cat([codes[0][:, :1], codes[1], codes[2]], 1)
        t["decode"] = median_ms(lambda: q_card.decode(stacked), 3)
        total, _ = q_card.decode(stacked)
        t0 = time.perf_counter()
        codes_cpu, _ = q_cpu.encode(z.cpu(), wt, n_c=2)
        total_cpu, _ = q_cpu.decode(stacked.cpu())
        cpu_s = time.perf_counter() - t0
    shares = [float((a.cpu() == b).float().mean()) for a, b in zip(codes, codes_cpu)]
    dec = float((total.cpu() - total_cpu).abs().max())
    log(f"  forward_v1: 8 VQ launches, outs {tuple(outs.shape)} finite, commitment "
        f"{float(commit):.4g}, codebook {float(cb):.4g}; codes (c, p, t, r) equal to the CPU's "
        + ", ".join(f"{v:.5f}" for v in shares) + f"; decode of equal codes max abs {dec:.2e} "
        f"(limit {DECODE_MAX_DIFF}); card ms forward_v1 {t['forward_v1']:.2f}, encode "
        f"{t['encode']:.2f}, decode {t['decode']:.2f}; the CPU's encode + decode {cpu_s:.1f} s "
        f"[{smi}]")
    if min(shares) < CODE_MATCH_MIN or not dec <= DECODE_MAX_DIFF:
        raise AssertionError(f"19d: code shares {shares}, decode gap {dec}")
    del q_card, q_cpu, z
    torch.cuda.empty_cache()
    return dict(launches=launched, code_shares=shares, decode_max_abs=dec, ms=t)


def main() -> None:
    t_start = time.perf_counter()
    smi = phase_device()
    with float32_exact():
        log(f"TF32 inside FACodec calls: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
            f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    log(f"TF32 outside (torch defaults, untouched): cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32} cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}")

    t0 = time.perf_counter()
    codec = FACodec.from_fields(FLAGSHIP, seed=0, device="cuda")
    n_params = sum(p.numel() for m in (codec.encoder, codec.quantizer, codec.decoder)
                   for p in m.parameters())
    log(f"flagship codec: {n_params} parameters, seed 0, built in {time.perf_counter() - t0:.1f} s")

    w = sweep_wave(BATCH, SECONDS)
    ru = phase_resunit(
        f"phase 2a: fused_residual_unit vs plain on the main path's inputs (one reconstruct, "
        f"batch {BATCH} x {SECONDS:.0f} s)",
        unit_inputs((codec.encoder, codec.decoder), lambda: codec.reconstruct(w), 24))
    vqr = phase_vq(codec, w)
    main_path = phase_slice(codec, w)
    cpu = phase_cpu(codec)

    t0 = time.perf_counter()
    red = FARedecoder.from_fields(FLAGSHIP_REDECODER, seed=1, device="cuda")
    n_params = sum(p.numel() for m in (red.encoder, red.decoder) for p in m.parameters())
    log(f"flagship redecoder: {n_params} parameters, seed 1, built in "
        f"{time.perf_counter() - t0:.1f} s")
    codec_vc = FACodec(codec.encoder, codec.quantizer, codec.decoder, n_c=1)
    target = sweep_wave(BATCH, SECONDS, seed=1)
    vc_counts, codes, timbre = phase_vc(codec_vc, red, w, target, smi)
    ru_vc = phase_resunit(
        f"phase 5a: fused_residual_unit vs plain on the 12 non-causal decoder units of one "
        f"resynthesis (batch {BATCH} x {SECONDS:.0f} s)",
        unit_inputs((red.decoder,), lambda: red.resynthesize(codes, timbre), 12))
    ru["max_abs_err"] = max(ru["max_abs_err"], ru_vc["max_abs_err"])
    phase_vc_cpu(codec_vc, red)
    phase_fac(codec, w)

    hooks, captured, armed = stream_inputs(codec)
    st16 = phase_stream(codec, 1, 16, armed)
    st4 = phase_stream(codec, 4, 4, armed)
    for h in hooks:
        h.remove()
    halo = phase_halo(codec, captured)
    ru["max_abs_err"] = max(ru["max_abs_err"], halo.pop("max_abs_err"))
    phase_encode_streaming(codec)
    phase_stream_vc(codec_vc)

    codec_hy = FACodec(codec.encoder, codec.quantizer, codec.decoder, precision="hybrid")
    hy = phase_hybrid(codec, codec_hy, cpu, w)
    f32_codes = hy.pop("f")
    bf = phase_bf16(unit_inputs((codec_hy.decoder,), lambda: codec_hy.decode(f32_codes), 12))
    pol = phase_policies(codec, codec_hy, cpu, w, smi)
    bn = phase_bench(codec, smi)
    sv = phase_serve(codec_hy)
    live = phase_live(codec_hy)
    art = phase_artifact(codec, w, smi)
    li = phase_lstm_int8(codec, cpu, smi)
    t19d = time.perf_counter()
    v1 = phase_forward_v1(codec, cpu, w, smi)
    t19d = time.perf_counter() - t19d
    del codec, codec_hy, codec_vc, cpu, red
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    train_models = build_models(FLAGSHIP_TRAIN, 0, "cuda")
    n_params = {k: sum(p.numel() for p in m.parameters()) for k, m in train_models.items()}
    log(f"flagship training modules (FLAGSHIP_TRAIN, seed 0): {n_params} parameters, built in "
        f"{time.perf_counter() - t0:.1f} s")
    batch = train_batch(TRAIN_BATCH, TRAIN_FRAMES, 0, "cuda")
    tk = phase_train_kernels(train_models, batch)
    t19 = time.perf_counter()
    bt_units = phase_bf16_train_units(train_models, batch, smi)
    bt_steps = phase_bf16_train_steps(train_models, smi)
    t19 = time.perf_counter() - t19
    del train_models, batch
    torch.cuda.empty_cache()
    ru["max_abs_err"] = max(ru["max_abs_err"], tk["max_abs_err"])
    tc = phase_train_cpu()
    bt_cpu = tc["bf16_step_max_rel"]
    tr = phase_train(smi)

    t0 = time.perf_counter()
    red_codec, red_models = red_setup("cuda")
    n_params = {k: sum(p.numel() for p in m.parameters())
                for k, m in (*red_codec.items(), *red_models.items())}
    log(f"redecoder training modules (FLAGSHIP_REDECODER_TRAIN: frozen codec seed 1, trained "
        f"modules seed 0): {n_params} parameters, built in {time.perf_counter() - t0:.1f} s")
    rk = phase_red_kernels(red_codec, red_models, red_batch(TRAIN_BATCH, TRAIN_FRAMES, 0, "cuda"))
    del red_codec, red_models
    torch.cuda.empty_cache()
    ru["max_abs_err"] = max(ru["max_abs_err"], rk["max_abs_err"])
    rc = phase_red_cpu()
    rt = phase_red_train(smi)
    va = phase_variants()
    own_data, own_tr, own_sc = phase_own(smi)
    dp = phase_dp(smi)
    shard2 = dp["shard"]["2 on cuda:0"]["launches"]
    ep = phase_entry_points(smi, dp["gloo"])
    del dp["gloo"]["one"], dp["gloo"]["tp"]  # the runs' tensors, held by 17a
    tp_launches = ep["tp"]["fused"]["launches"]
    va_launches = ep["validate"]["launches"]
    ui_launches = {k: v["launches"] for k, v in ep["webui"].items()}

    def bench_launches(key: str) -> dict:
        """The kernel's launches in one round trip of the bench (16a), by policy."""
        return {p: bn["launches"][p].get(key, 0) for p in BENCH_POLICIES}

    def entry_launches(key: str) -> dict:
        """The kernel's launches on phase 17's entry points, from its counter."""
        return dict(tp_step_launches=tp_launches[key], validate_launches=va_launches[key],
                    webui_reconstruct_launches=ui_launches["reconstruct"][key],
                    webui_convert_launches=ui_launches["convert"][key])

    def bf16_train_launches(key: str) -> dict:
        """The kernel's launches a 19c step under each bf16 training policy."""
        return dict(bf16_train_launches={p: bt_steps[p]["per_step"].get(key, 0)
                                         for p in BF16_TRAIN})

    def bf16_train(precision: str) -> dict:
        """A bf16 form's numbers in training under `precision` (19a, 19c)."""
        u, st = bt_units[precision], bt_steps[precision]
        return dict(train_policy=precision, bf16_train_ms=st["kernel_ms"][RESUNIT_BF16],
                    train_grad_max_rel=u["grad_max_rel"], train_fwd_ulps=u["max_ulps"],
                    train_fwd_ms=u["fwd_ms"], train_fwd_plain_ms=u["fwd_plain_ms"],
                    train_fwd_bwd_ms=u["fwd_bwd_ms"], train_fwd_bwd_plain_ms=u["fwd_bwd_plain_ms"],
                    train_flops=u["flops"], train_bound_ms=u["bound_ms"],
                    train_bound_by=u["bound_by"])

    # no single PyTorch call computes either function: library_ms is null
    kernels = [
        dict(name="fused_residual_unit", route="cuda", source="facodec_tpu_torch/csrc/resunit.cu",
             replaces="facodec_tpu/ops/pallas/resunit.py:273", launches=main_path["resunit"],
             vc_launches=vc_counts[0], stream_launches=st16["halo"],
             hybrid_launches=hy["launches"]["f32"], train_launches=tr["per_step"]["f32"],
             train_ms=tr["kernel_ms"][RESUNIT_F32],
             train_grad_max_rel=tk["grad_max_rel"],
             redecoder_train_launches=rt["per_step"]["f32"],
             redecoder_train_ms=rt["kernel_ms"][RESUNIT_F32],
             redecoder_grad_max_rel=rk["grad_max_rel"],
             teacher_train_launches=own_tr["per_step"]["f32"],
             eval_launches=own_sc["eval_launches"]["float32"]["f32"],
             artifact_launches=art["launches"]["float32"]["f32"],
             artifact_hybrid_launches=art["launches"]["hybrid"]["f32"],
             dp_step_launches=dp["nccl"]["a"]["launches"]["f32"],
             dp_gloo_step_launches=dp["gloo"]["fused"]["launches"]["f32"],
             sharded_reconstruct_launches=shard2["float32"]["f32"],
             sharded_hybrid_launches=shard2["hybrid"]["f32"], bound_by="operations",
             bench_launches=bench_launches("f32"), bench_train_launches=24,
             **entry_launches("f32"), **bf16_train_launches("f32"),
             library_ms=None, **ru, **halo),
        dict(name="nearest_code", route="cuda", source="facodec_tpu_torch/csrc/vq.cu",
             replaces="facodec_tpu/ops/pallas/vq.py:76", launches=main_path["vq"],
             vc_launches=vc_counts[1], stream_launches=st16["vq"],
             hybrid_launches=hy["launches"]["vq"], train_launches=tr["per_step"]["vq"],
             train_ms=tr["kernel_ms"][PROFILE_VQ], train_grad_max_rel=tk["vq_grad_max_rel"],
             redecoder_train_launches=rt["per_step"]["vq"],
             redecoder_train_ms=rt["kernel_ms"][PROFILE_VQ],
             teacher_train_launches=own_tr["per_step"]["vq"],
             eval_launches=own_sc["eval_launches"]["float32"]["vq"],
             artifact_launches=art["launches"]["float32"]["vq"],
             dp_step_launches=dp["nccl"]["a"]["launches"]["vq"],
             dp_gloo_step_launches=dp["gloo"]["fused"]["launches"]["vq"],
             sharded_reconstruct_launches=shard2["float32"]["vq"],
             sharded_hybrid_launches=shard2["hybrid"]["vq"],
             bench_launches=bench_launches("vq"), bench_train_launches=6,
             **entry_launches("vq"), **bf16_train_launches("vq"), v1_launches=v1["launches"],
             bound_by="operations", library_ms=None, **vqr),
        # the bf16 entry (csrc/resunit_bf16.cu): its main path is the hybrid
        # round trip (the serve default), whose 12 decoder units it runs
        dict(name="fused_residual_unit_bf16", route="cuda",
             source="facodec_tpu_torch/csrc/resunit_bf16.cu",
             replaces="facodec_tpu/ops/pallas/resunit.py:273", launches=hy["launches"]["bf16"],
             hybrid_launches=hy["launches"]["bf16"], train_launches=0,
             redecoder_train_launches=0, teacher_train_launches=0,
             eval_launches=own_sc["eval_launches"]["hybrid"]["bf16"],
             artifact_launches=art["launches"]["hybrid"]["bf16"],
             dp_step_launches=dp["nccl"]["a"]["launches"]["bf16"],
             sharded_reconstruct_launches=shard2["float32"]["bf16"],
             sharded_hybrid_launches=shard2["hybrid"]["bf16"],
             decode_kernels=hy["decode_kernels"],
             decode_kernels_per_call_pack=hy["decode_kernels_per_call_pack"], library_ms=None,
             bench_launches=bench_launches("bf16"), **entry_launches("bf16"),
             hybrid_int8_launches=pol["launches"]["hybrid_int8"].get("bf16", 0),
             **bf16_train_launches("bf16"), **bf16_train("bfloat16_act"), **bf),
        # phase 15: the bf16 kernel's float32-in/out forms and the int8 unit
        dict(name="fused_residual_unit_f32io", route="cuda",
             source="facodec_tpu_torch/csrc/resunit_bf16.cu",
             replaces="facodec_tpu/ops/pallas/resunit.py:273",
             launches=pol["launches"]["bfloat16"]["f32io"], policy="bfloat16", library_ms=None,
             bench_launches=bench_launches("f32io"), **entry_launches("f32io"),
             **bf16_train_launches("f32io"), **bf16_train("bfloat16"), **pol["k1"]),
        dict(name="fused_residual_unit_f32io_act", route="cuda",
             source="facodec_tpu_torch/csrc/resunit_bf16.cu",
             replaces="facodec_tpu/ops/pallas/resunit.py:273",
             launches=pol["launches"]["hybrid_int8"]["act"], policy="hybrid_int8",
             bench_launches=bench_launches("act"), **entry_launches("act"),
             **bf16_train_launches("act"), library_ms=None, **pol["k1a"]),
        dict(name="fused_residual_unit_int8", route="cuda",
             source="facodec_tpu_torch/csrc/resunit_int8.cu",
             replaces="facodec_tpu/ops/pallas/resunit.py:273",
             launches=pol["launches"]["hybrid_int8"]["int8"],
             amax_launches=pol["launches"]["hybrid_int8"]["amax"], policy="hybrid_int8",
             bench_launches=bench_launches("int8"), **entry_launches("int8"),
             **bf16_train_launches("int8"),
             status="redesigned: wgmma s8 and bf16, the weights and the s2 tile by TMA and "
                    "bulk copies through an mbarrier ring, persistent grid",
             library_ms=None, **pol["k2"]),
        # phase 18: the opt-in W8A8 LSTM recurrence; its main path is the
        # flagged hybrid decode, whose decoder SLSTM runs it once a layer.
        # cuDNN computes another function (float32 weights, no quantization):
        # its time on the same shapes is cudnn_lstm_ms, not library_ms
        dict(name="lstm_int8", route="cuda", source="facodec_tpu_torch/csrc/lstm_int8.cu",
             replaces="facodec_tpu/nn/lstm.py:110",
             replaces_note="not a TPU kernel: the XLA scan of lstm_layer's int8 branch",
             launches=li["launches"]["hybrid"], hybrid_int8_launches=li["launches"]["hybrid_int8"],
             library_ms=None, **{k: v for k, v in li.items() if k not in ("launches", "profile")}),
    ]
    log(f"streaming: chunk 16 batch 1 p50 {st16['p50_ms']:.2f} ms ({st16['rtf']:.1f}x realtime, "
        f"device {st16['device_ms']:.2f} ms of a traced {st16['traced_wall_ms']:.2f} ms), "
        f"chunk 4 batch 4 p50 {st4['p50_ms']:.2f} ms ({st4['rtf']:.1f}x realtime, device "
        f"{st4['device_ms']:.2f} ms of a traced {st4['traced_wall_ms']:.2f} ms)")
    log(f"hybrid: round trip {hy['hybrid_s']:.3f} s (warm f32 {hy['f32_times']}, hybrid "
        f"{hy['hybrid_times']}); serve {sv['rps_concurrent']:.2f} requests/s concurrent, "
        f"{sv['rps_sequential']:.2f} sequential; live ticks "
        + ", ".join(f"{n} streams p50 {v['p50_ms']:.2f} p95 {v['p95_ms']:.2f} ms"
                    for n, v in live.items() if n != "group_alone"))
    log(f"training: step {tr['step_ms']:.1f} ms median, {tr['steps_s']:.2f} steps/s, "
        f"{tr['audio_s_per_s']:.2f} s of audio per s, peak {tr['peak_bytes'] / 2**30:.2f} GiB; "
        f"card vs CPU step {tc['step_max_rel']:.2e}; kernel gradients {tk['grad_max_rel']:.2e} "
        f"(resunit), {tk['vq_grad_max_rel']:.2e} (VQ) [{smi}]")
    log(f"redecoder training: step {rt['step_ms']:.1f} ms median, {rt['steps_s']:.2f} steps/s, "
        f"{rt['audio_s_per_s']:.2f} s of audio per s, peak {rt['peak_bytes'] / 2**30:.2f} GiB, "
        f"device kernels {rt['device_ms']:.1f} ms of a traced {rt['traced_wall_ms']:.1f} ms; "
        f"card vs CPU step {rc['step_max_rel']:.2e}; non-causal unit gradients "
        f"{rk['grad_max_rel']:.2e}; 12 units forward kernel {rk['fwd_ms']:.2f} ms plain "
        f"{rk['fwd_plain_ms']:.2f} ms, forward+backward kernel {rk['fwd_bwd_ms']:.2f} ms plain "
        f"{rk['fwd_bwd_plain_ms']:.2f} ms [{smi}]")
    for label, runs in va.items():
        log(f"{label} step variants: " + "; ".join(
            f"{v} peak {r['peak_bytes'] / 2**30:.2f} GiB, launches {r['launches']}, "
            f"step {r['ms']:.1f} ms"
            for v, r in runs.items()))
    log(f"own data: teacher {own_data['teacher_ms_per_audio_s']:.3f} ms per s of audio, F0 "
        f"card vs CPU {own_data['f0_max_rel']:.2e} of max|F0|; step with the teacher "
        f"{own_tr['step_ms']:.1f} ms against {own_tr['offline_step_ms']:.1f} ms with the batch's "
        f"F0 (teacher {own_tr['teacher_ms']:.3f} ms), card vs CPU {own_tr['step_max_rel']:.2e}; "
        f"evaluate_utterance {own_sc['eval_ms']['float32']:.1f} ms float32, "
        f"{own_sc['eval_ms']['hybrid']:.1f} ms hybrid per 10 s; hybrid vs float32 SI-SDR "
        + ", ".join(f"{v:.2f}" for v in own_sc["hybrid_si_sdr_db"]) + f" dB [{smi}]")
    log(f"artifact: export " + "; ".join(
        f"{p} {sum(v.values()):.1f} s ({len(v)} functions), {art['art_bytes'][p]} B"
        for p, v in art["export_s"].items())
        + f" against a {art['ckpt_bytes']} B checkpoint; reconstruct medians "
        + "; ".join(f"{p} live {t['median']['live']:.2f} ms, artifact "
                    f"{t['median']['artifact']:.2f} ms" for p, t in art["times"].items())
        + f"; served {', '.join(f'{r:.2f}' for r in art['rps_artifact'])} requests/s against "
        f"live {', '.join(f'{r:.2f}' for r in art['rps_live'])} [{smi}]")
    a, sh = dp["nccl"]["a"], dp["shard"]
    log(f"data parallel: NCCL world {a['world']} step {a['dp_ms']:.1f} ms against plain "
        f"{a['plain_ms']:.1f} ms, all-reduce {a['reduce_ms']:.2f} ms over {a['reduce_bytes']} "
        f"bytes; 2 gloo ranks on one card "
        + "; ".join(f"{v} rank steps {[round(t, 1) for t in dp['gloo'][v]['rank_ms']]} ms "
                    f"against {dp['gloo'][v]['one_ms']:.1f} ms" for v in ("fused", "split"))
        + "; sharded reconstruct ms (unsharded / sharded) "
        + "; ".join(f"{name}: " + ", ".join(f"{k} {v['unsharded']:.1f} / {v['sharded']:.1f}"
                                            for k, v in r["ms"].items())
                    for name, r in sh.items())
        + f"; serve requests/s unsharded {[round(r, 2) for r in dp['serve']['rps']['unsharded']]}"
        f" sharded {[round(r, 2) for r in dp['serve']['rps']['sharded']]} [{smi}]")
    tpf, va, ui = ep["tp"]["fused"], ep["validate"], ep["webui"]
    log(f"entry points: tensor-parallel fused step (2 gloo ranks, data 1 x model {TP_MODEL}) rank "
        f"ms {[round(t, 1) for t in tpf['rank_ms']]} against one process {tpf['one_ms']:.1f}, "
        f"sharded tensors {tpf['sharded_bytes'][0]} of {tpf['sharded_bytes'][1]} bytes a rank; "
        f"validate {json.dumps(va['line'])} exit {va['rc']}, codes {va['code_share']:.5f}; webui "
        + "; ".join(f"{k} {[round(t, 1) for t in v['ms']]} ms, {v['lsb']} LSB"
                    for k, v in ui.items()) + f" [{smi}]")
    log(f"policies: round trips (s, in turns) " + "; ".join(
        f"{p} {', '.join(f'{t:.3f}' for t in v)}" for p, v in pol["times"].items())
        + f"; bfloat16 codes equal to float32's {pol['bf16_code_share']:.4%}; SI-SDR vs float32 "
        + "; ".join(f"{p} {min(v):.2f} dB" for p, v in pol["si_sdr_db"].items()) + f" [{smi}]")
    log("bench: " + "; ".join(f"{p} {v['value']}x realtime, mfu {v['mfu']}"
                              for p, v in bn["lines"].items())
        + f" (batch {BENCH_BATCH} x {BENCH_SECONDS:.0f} s); streaming chunk p50 "
        f"{bn['stream']['value']} ms, device {bn['stream']['device_op_ms']} ms; train step "
        f"{bn['train']['value']} ms; traced hybrid / hybrid_int8 device ms by kind "
        + "; ".join(f"{p} " + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
            r["by_kind"].items(), key=lambda kv: -kv[1])[:5]) for p, r in bn["profiles"].items())
        + f" [{smi}]")
    log(f"W8A8 LSTM (FACODEC_LSTM_INT8, phase 18): kernel {li['ms']:.3f} ms for both layers "
        f"(plain {li['plain_ms']:.1f} ms, bound {li['bound_ms']:.4f} ms, serial floor "
        f"{li['serial_floor_ms']:.3f} ms); decoder LSTM flagless -> flagged "
        + "; ".join(f"{p} {v['flagless']:.2f} -> {v['flagged']:.2f} ms"
                    for p, v in li["decoder_lstm_ms"].items()) + f" [{smi}]")
    log(f"bf16 training (phase 19, {t19:.1f} s for 19a and 19c, {t19d:.1f} s for 19d; 19b in "
        f"10b): step ms "
        + "; ".join(f"{p} {v['step_ms']:.1f} (peak {v['peak_bytes'] / 2**30:.2f} GiB)"
                    for p, v in bt_steps.items())
        + "; the 24 units forward / forward+backward ms "
        + "; ".join(f"{p} {v['fwd_ms']:.2f} / {v['fwd_bwd_ms']:.2f} (plain {v['fwd_plain_ms']:.2f}"
                    f" / {v['fwd_bwd_plain_ms']:.2f}), gradients {v['grad_max_rel']:.2e}"
                    for p, v in bt_units.items())
        + "; card vs CPU losses " + ", ".join(f"{p} {v:.2e}" for p, v in bt_cpu.items())
        + f"; forward_v1 codes {min(v1['code_shares']):.5f} equal to the CPU's [{smi}]")
    if klstm.lstm_int8.launches:
        raise AssertionError(f"the W8A8 LSTM kernel launched {klstm.lstm_int8.launches} times "
                             f"after phase 18, where the flag is off")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
