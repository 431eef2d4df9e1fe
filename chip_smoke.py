#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (polykey_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Phases, each reported on its own line and each followed by
torch.cuda.synchronize(); any failure ends the run with a non-zero exit:

1. device:  the card's name, compute capability and power limit.
2. build:   nvcc builds the CUDA kernels from polykey_tpu_torch/csrc.
2a. train:  the training path (polykey_tpu_torch.train) on the full
            32-layer Llama-3-8B at its published widths, bf16 weights drawn
            on the card from --seed, with nothing else on the card:
            initialize_from_env over a one-rank NCCL group
            (POLYKEY_COORDINATOR=127.0.0.1:<free port>, one process),
            mesh_from_env, make_train_step (the whole forward checkpointed,
            fused AdamW(1e-4, weight decay 0.01), moments in bf16; every
            collective issued over its group of one), 6 steps on one fixed
            batch of 2 x 512 tokens. Every loss finite, the first within 1.0
            of ln(128256) = 11.76, the last below the first (the batch is
            memorised). It prints the losses, the first step's wall, the
            later steps' median and range, tokens/s, the peak memory
            allocated and the model-FLOP utilisation against the dense bf16
            peak (8 x parameters x tokens a step: forward, backward and the
            recomputed forward), one more step's device time under
            torch.profiler by part (GEMMs, optimizer, collectives, softmax,
            the rest) with its 8 costliest kernels, and each kernel's
            launches in the phase
            (all 0: the reference's training runs no Pallas kernel). The
            group is destroyed and the memory allocated must fall back
            under 1 GiB.
3. kernels: each kernel against its plain PyTorch version on the card, at
            Llama-3-8B shapes in bf16: largest error against the stated
            tolerance, kernel / plain / library-call times (CUDA events) and
            the least time the card could take (the roofline bound). The
            ragged kernel at the engine's default ragged stream: 16 decode
            singles over 1..4096 keys plus two 512-token chunks (T = 1040),
            at profile_decode --ragged's (16 lanes at context 512), and
            the 16 singles alone.
            Both paged writes (the copy and the quantizing one) at 16
            lanes and at a 1040-row ragged stream, exact, beside the
            launch floor (an empty kernel timed back to back). Then the
            int8-KV variants at the same shapes: decode and ragged over
            int8 pools with bf16 scales. The speculative draft's shapes
            (Llama-3.2-1B, D=64): decode (bf16 and int8) at contexts
            1..4096 and at 16 lanes of 512, both writes at 16 lanes, and
            flash at T=512, each against its plain version with its D=128
            case's tolerance. The same at Gemma-2's geometries
            (GEMMA_SHAPES: gemma-2-27b Hq 32, Hk 16, D 128, scale 144^-0.5;
            gemma-2-2b Hq 8, Hk 4, D 256, scale 256^-0.5; soft-cap 50,
            window 4096): bf16 decode, flash, both writes.
4. slice:   a full-width, depth-2 Llama-3-8B runs prefill (bucket 128) and
            8 decode steps through forward_paged, once through the kernels
            and once through their plain versions; the logits must agree.
            Then a mixed prefill+decode run through forward_ragged, kernels
            against plain and against forward_paged on the same tokens.
            Both again over int8 KV, kernels against plain, and the hidden
            states against the bf16-KV runs (the reference's 0.05 gate).
            The bucketed slice with int8 and int4 weights (quantized as the
            engine quantizes them) against bf16 weights, under the
            reference's gates (mean |dh| / max(|h|, 1) under 0.05 and
            0.35). Then a depth-2 mixtral-8x7b at its published widths (8
            experts, top-2, the capacity-bucketed dispatch) in int8
            weights, kernels against plain within 0.12 with the same argmax
            on every row; it prints how many token routings the two runs
            chose differently. Last, a depth-2 gemma-2-27b at its published
            widths (layer 0 windowed, layer 1 global) on tables of 8192
            positions: 4096 positions of history, a 512-token bucket at
            4096..4607 and 8 decode steps past the window, kernels against
            plain within 0.12 with the same argmax on every row.
5. serve:   the full 32-layer Llama-3-8B (random bf16 weights from --seed)
            behind the port's gRPC server on a free local port, with the
            default EngineConfig; 5 concurrent llm_generate requests, one of
            them a ~1500-token prompt (chunked prefill). Every kernel's
            launch count is set to 0 before this phase; the bucketed path's
            kernels must have risen after it, and no other.
6. ragged:  the same weights behind a second engine with ragged_dispatch
            on, the same requests: the ragged, decode and write kernels
            must have launched, the flash kernel not (every prefill rides
            the ragged stream).
7. serve-int8, ragged-int8: phases 5 and 6 again with kv_dtype="int8"
            (POLYKEY_KV_DTYPE=int8): only the int8 variants of decode,
            write and ragged run, beside flash in the bucketed mode.
            Every serve runs the default pipeline: lookahead depth 2 and
            the adaptive block, each decode block a replay of one of the
            four CUDA graphs the engine captured at start ((greedy,
            sampled) x (8, 1) steps), and in the bucketed serves each
            prefill and chunk a replay of one of 16 prefill graphs
            (buckets 128, 512 x group pads 1, 2, 4, 8 x greedy, sampled),
            its first token read lazily; a ragged dispatch goes out
            without draining the blocks in flight. Each prints the graphs'
            capture seconds and pool bytes, its replays, the observed
            lookahead and the host stall p50, and fails unless the decode
            graphs were replayed in it, and (bucketed) unless the prefill
            graphs were, no prefill ran eagerly and every flash launch came
            from a prefill replay, or (ragged) unless a ragged dispatch
            went out with another block in flight.
7a. mesh:   serving over a mesh (engine/lockstep.py) on the serve phases'
            weights: initialize_from_env over a one-rank NCCL group
            (POLYKEY_COORDINATOR=127.0.0.1:<free port>, one process), then
            the default EngineConfig's Llama-3-8B at MESH_FEATURE_LAYERS (4)
            of its layers (full width; the serve weights' first layers),
            which takes the mesh path because the group is up (its
            collectives, a group of one's copies, captured in the CUDA
            graphs), bf16 KV and then int8 KV, each beside the single-card
            engine of the same config served first (before the group is
            up). MESH_PROMPTS (the serve phase's five prompts) over
            streamed gRPC, greedy, 32 tokens, one at a time: every stream
            must be token for token the single-card engine's (a group of
            one computes exactly what one card does), every decode block
            and prefill a graph replay (none eager), flash and the KV
            type's decode and write kernels launched, no weight copied, and
            every collective of the 34 captured forwards issued inside a
            capture (340 at 4 layers). It prints the NCCL version, the
            capture seconds against the single-card engine's, the 8-step
            decode block's and the 512-token prefill's replay walls at idle
            in turns against the single-card engine (shut down, its graphs
            kept for this; the cost of the captured collectives over a
            group of one), and one decode replay's device activities under
            torch.profiler. Then the same depth from a checkpoint: those
            layers' bf16 weights written as an HF checkpoint (two
            shards and an index, in a temporary directory removed at the
            end) and read by a mesh engine (checkpoint_path) as its rank's
            shard of each tensor (the whole of it, on a group of one): the
            tree bit for bit the one written, MESH_PROMPTS token for token
            the bf16 single-card engine's of that depth (the full-depth
            checkpoint reads are phase 7b's and phase 17's); it prints the
            write's and the load's seconds, the bytes copied and the load's
            peak device memory.
            The group is destroyed at the end. The kernels phase holds the
            kernels at a mesh rank's shard shapes too: decode (bf16 and
            int8) at Llama-3-8B tp=2 (Hq 16, Hk 4) and tp=4 (Hq 8, Hk 2) at
            contexts 1..4096 and 16 lanes of 512, and Gemma-2-27B tp=2 (Hq
            16, Hk 8); the sp=2 decode's two page-range halves merged
            against the whole range; flash at tp=4's heads and on sp=2's
            second query block against the whole window; both writes at Hk
            4 and 2; both ragged kernels at Llama-3-8B tp=2 and tp=4's
            heads, at the serve case and the spec stream, each cut into
            work items for those heads; the 1B draft's D=64 decode (bf16
            and int8) at tp=2's heads (Hq 16, Hk 4). Phase 11a runs the
            engine's own features on the mesh engine. pp needs a second
            rank: it runs on the CPU only
            (tests/test_torch_engine_mesh_features.py).
7b. orbax:  (run inside phase 11, whose plain bf16 engine it is) the
            reference's own checkpoint format (OCDBT + zarr + zstd)
            on one card: the serve weights (32-layer Llama-3-8B) written by
            the port's save_checkpoint (raw-block zstd frames, streamed a
            chunk at a time through one pinned buffer) into a temporary
            directory (free space checked first; removed at the end), and
            a single-card InferenceEngine with that checkpoint_path: the
            tree bit for bit the serve weights, MESH_PROMPTS one at a time
            token for token the bf16 serve phase's, flash, the paged write
            and the paged decode launched from it. It prints the bytes and
            seconds of the write, the read's seconds, bytes decoded and
            copied, the load's peak device memory, and the phase's wall.
8. graph:   the full-depth Llama-3-8B decode block (16 greedy lanes at
            context 512, as profile_decode sets it up; bf16 and int8 KV),
            eager and as a replay of its graph, from the same lane state:
            the packed tokens and the final lane state must be identical;
            then both in turns (eager, graph, graph, eager, ...), each
            run's wall per step on the host clock and its idle share from
            torch.profiler.
9. prefill-graph: the full-depth bucketed prefill (512 tokens at positions
            1024..1535, 1 and 8 rows, greedy; bf16 and int8 KV), eager and
            as a replay of its graph, from the same pools: the sampled
            tokens and the KV pages of the rows must be identical; then
            both in turns, 3 runs each, each run's wall and idle share.
10. prefix: the prefix cache and the host-KV tier on the same weights. A
            1024-token shared header (64 pages) plus a ~100-token tail is
            sent alone (a miss), then four requests with the same header
            and other tails at once (hits: each prefills its suffix only),
            32 greedy tokens each, on a bucketed bf16 engine (which also
            holds a host tier), a bucketed int8 engine and a ragged bf16
            engine, each beside an engine of the same mode with the cache
            off: every text (token ids) must equal the uncached one. Each
            prints the pages matched, the miss's and the hits' TTFT and
            (bucketed) the prefill graph replays, none of them eager. Then
            the host tier: a second header on the small bf16 pool spills
            the first to host memory, and the first sent again faults its
            pages back (restored in place: the pools keep their
            addresses) to the uncached text; it prints the pages spilled
            and restored, kv_restore_ms p50 / p95, the bytes of a restore
            and the header's TTFT recomputed cold. Last, pages gathered to
            a host pool and restored into other pages equal the originals
            bit for bit (bf16, and int8 values with their scales), with
            the restore's device time for 64 pages.
11. spec:   speculative decoding on the same weights, over gRPC, each beside
            the plain engine of its KV type on the same prompts (the serve
            phases' five, all greedy, 32 tokens; the plain bf16 engine is
            phase 7b's, read from the orbax checkpoint): (a) a Llama-3.2-1B draft
            (random weights from seed + 2) at gamma 4 over bf16 KV with
            top_p_candidates=64 and the prefix cache: the five, then four
            sampled requests (temperature 0.8, top_p 0.9), then the first
            prompt again (a prefix hit); (b) the target as its own draft
            (its own tensors): the five, whose acceptance must be at least
            0.9, then four sampled at top_p 0.7; (c) the 1B draft over
            int8 KV: the five; (d) and (e) the 1B draft with
            ragged_dispatch over bf16 and int8 KV: the five, the ~1500-token
            document sent once the other four have their first tokens, so
            its chunks ride ragged spec dispatches (engine/spec_decode.py,
            ragged_spec_fn) with their verify windows; pure-decode rounds
            stay graph replays. Each greedy text must equal the plain
            engine's, or differ first at a near-tie: both tokens' target
            logits, on the plain eager path over the common prefix, within
            0.12 of the top logit there (each such position is printed
            with its margin); the prefix hit's text is held to its first
            run's the same way. Every round must be a graph replay (none
            eager), no prefill eager, the decode and write kernels must
            launch, and no ragged kernel in (a)-(c); in (d) and (e) the
            ragged kernel of the KV type must launch and flash not, and a
            ragged spec dispatch must carry verify windows. Each prints the
            graph pool before and after the spec keys, the draft pool,
            acceptance, rounds, tokens a lane a round, and TTFT and tok/s
            against the plain engine; (d) and (e) also the ragged spec
            dispatches, their lanes and prefill ranges, and their wall on
            the card (CUDA events around each dispatch) beside the host's
            time in the call. On (c)'s engine, the spec_host_sync A/B: one
            greedy prompt alone (16 tokens) with the knob off and on, in
            turns, two each (the engine's config swapped while idle: no second
            engine); each turn prints its mean host stall, blocks_synced
            and tok/s; with the knob on every dispatched round makes three
            timed reads, landing in blocks_synced, and every turn's streams
            are the same token ids.
11a. mesh (features): the engine's own features on the mesh engine over
            a one-rank NCCL group brought up as in phase 7a, each held
            token for token to a single-card engine serving the same
            requests one at a time: at MESH_FEATURE_LAYERS (4) of Llama-3-8B's
            layers (full width; the single-card engines of the same config
            and depth served first), ragged_dispatch over bf16 and int8 KV
            (MESH_PROMPTS; the KV type's ragged kernel launched on the mesh
            engine, flash not) and the 1B draft at gamma 4 as in phase 11's
            (c) (bucketed, int8 KV) and (d) (ragged x spec, bf16 KV): the
            five greedy prompts, every round a graph replay with its
            collectives captured; and the prefix cache with phase 10's
            host tier (160 pages, 1 GiB of host memory) against a
            single-card engine of that config and depth: the header's
            miss, four hits, four more, one alone, the second header (which
            spills the first) and the first again (restored): the ids and
            the pages matched, spilled and restored equal to the
            single-card engine's, and the lone hit's TTFT not above the
            miss's; its spills go to a state dir (whole pages assembled
            from the ranks' shards) whose blobs and sidecars must be the
            single-card engine's byte for byte. Then the in-process
            restarts: the same mesh engine behind TorchService.create's
            supervisor (a 3 s watchdog window, a 1 s join), restarted three
            times, each into the mesh's next life (the old life's NCCL
            communicators aborted, new groups made and warmed by the fresh
            engine's captures): after a failure injected into its engine
            loop before any record of its dispatch goes out (the state dir
            reloaded into the fresh engine's host tier); (a) after the
            prefill-error point fires inside a prefill's dispatch; (b)
            after a 7 s step-stall wedges the engine thread past the window
            and the join, so the supervisor keeps it as an orphan, reaped
            once it wakes into its dead engine. After each, health is
            SERVING, the header's miss is served token for token as the
            single-card engine's with flash, decode and write launched, and
            the seconds from the failure to the fresh engine serving, its
            capture seconds and the memory allocated are printed; a
            collective on each aborted communicator must
            raise at once, and the flight recorder and
            polykey_engine_restarts_total must hold three restarts and the
            watchdog's trip. Each sub-phase prints its
            seconds, its engine's capture and its kernel launches; the
            group is destroyed at the end.
12. generate: offline generation over a contiguous KV cache
            (models/generate.py) on the same weights: `generate` greedy, 32
            tokens, of LONG's two ~390-token prompts right-padded into one
            window, cache of 1024 positions; then `speculative_generate`
            (gamma 4) with the 1B draft and with the target as its own
            draft. generate's texts are held to the plain engine's of
            phase 11 and speculative_generate's to generate's, each under
            the near-tie rule; the flash kernel must launch (the prefill
            window is >= 128 wide); it prints acceptance and tok/s.
13. shell: the serving shell around a Llama-3-8B engine on the same
            weights (bucketed, default EngineConfig but a 5 s watchdog
            window), served by build_server with an Observability bundle
            over TorchService.create (watchdog and supervisor), /metrics
            on an ephemeral port and POLYKEY_DEBUG_ENDPOINTS=1. (1) The
            five greedy prompts as the first concurrent group, each with an
            x-trace-id: the echo, each span tree (queue_wait, prefill ending
            at the first token's read, decode, detokenize; their durations
            printed), /metrics' TTFT count 5, reflection's four services,
            a /debug/profile capture (torch.profiler) during one request
            whose trace holds CUDA kernel activity. (2) A step-stall past
            the window plus the supervisor's 5 s join, timed to end inside
            the fresh engine's graph capture: the request in flight fails
            UNAVAILABLE, health (Watch) goes NOT_SERVING then SERVING,
            /metrics counts one stall and one restart, the flight recorder
            holds watchdog_stall and engine_restart, the fresh timeline
            opens with the restart note, the old thread's exit falls
            inside the capture window, memory allocated after the wedged
            engine's release is within 1 GiB of the first engine's, and
            the five texts equal the first engine's under the near-tie rule
            with flash, paged decode and paged write (bf16) launched. (3)
            prefill-error@1 fails one request, the next four complete, no
            restart. Faults are installed on the live engine
            (polykey_tpu_torch/faults.py).
14. replicas: two Llama-3-8B replicas on the same weight tensors behind
            ReplicaPool.create (prefix cache on, bf16 KV, a 2 s watchdog
            window, the signal plane at 0.5 s with the default SLO policy),
            lookahead 3 set through the pool's apply_engine_knobs, then the
            autopilot armed over the pool; served by build_server over
            TorchService.create with /metrics and /debug on. It prints each
            replica's capture seconds and the memory allocated. (b) The
            port's dev client (python -m polykey_tpu_torch.gateway.client):
            its four checks, then each of the spec phase's five greedy
            prompts with --stream; the token ids are held to the plain
            engine's under the near-tie rule. A 1023-token shared header
            with two tails: the second request must route prefix-hit to
            the replica holding the header (its `replica` trailer and
            polykey_router_decisions_total{reason="prefix-hit"}). (c) A
            greedy stream paced by slow-step; after its fourth token a
            step-stall of 3 s on its replica (":replica=" scope): the same
            RPC completes on the other replica with trailers `replica` and
            `restarted: 1` and the uninterrupted run's ids (near-tie rule);
            the stalled replica restarts to SERVING on the shared weights
            with the memory allocated within 0.1 GiB of before; it prints
            the trip-to-SERVING seconds. (d) /metrics carries the pool, SLO
            and autopilot families, /debug/slo a snapshot, and the fresh
            replica's lookahead is the autopilot's setpoint (3 or more; it
            boots with 2). Only flash, the bf16 decode and the bf16 write
            kernels launch; it prints each replica's ITL p50 / p95.
14a. mesh (replicas): two replicas on the serve phases' weight tensors
            (their first MESH_FEATURE_LAYERS layers), each over its own
            one-rank mesh (its own data, control and pages groups):
            MESH_PROMPTS one at a time, the replicas in turn, token for
            token the single-card engine of the same depth.
15. disagg: after the Llama weights are freed (their fingerprint taken
            first), a 1x1 disaggregated pool (DisaggPool.create,
            POLYKEY_DISAGG="1x1", engine/disagg_pool.py): a prefill worker
            and a decode worker, each a real process
            (python -m polykey_tpu_torch.engine.worker) holding its own
            32-layer Llama-3-8B drawn from --seed (the stats reply's weight
            fingerprint must be the parent's), 4.00 GiB of KV and its graphs,
            both started at once. Served by build_server over
            TorchService.create with /metrics: (b) the five greedy prompts,
            streamed one at a time, their ids held to the plain engine's
            (phase 11) under the near-tie rule, each with the `tier` trailer
            "prefill=0,decode=0"; each prints its blob's bytes and its
            handoff by part (gather, serialize, the socket hops, deserialize,
            the decode worker's import on the card). (c) A lone greedy
            stream of 320 tokens with the 1509-token document sent after
            its 24th token: the stream's inter-token gaps before, while the
            prefill worker prefills the document, while its blob travels and
            is imported, and after. (d) The decode
            worker is armed (the arm_faults op) to call os._exit after 8
            forwarded tokens of the next stream: the pool must start a new
            decode process and re-ship the retained blob (the prefill
            worker's admissions +1, handoffs retried +1), the stream must
            complete with trailers `tier` and `restarted: 1` and the
            uninterrupted run's ids (near-tie rule), /metrics must carry the
            tier-labelled families. (e) The merged Perfetto timeline must
            hold three process rows and a handoff arc; each worker's kernel
            launches come from its stats reply (flash in the prefill worker,
            the decode kernel and the write in both decode workers). Every
            worker process must be gone at the end (their process groups
            are killed in any case). A text that differs is held to the
            near-tie rule on the weights drawn again in this process.
15a. mesh (disagg): a second 1x1 pool, its workers one-rank meshes
            (DisaggPool.create(mesh_workers=True): each worker process
            brings a group of one up, so its engine takes the mesh path and its handoffs
            move whole pages through lockstep's gather and scatter): the
            five greedy prompts one at a time, token for token phase 15's
            pool, every handoff imported, each worker's kernel launches
            printed.
16. serve-mixtral: after the Llama weights are freed, the full 32-layer
            mixtral-8x7b (46.7 B parameters, random weights from --seed,
            drawn and quantized to int8 a layer at a time: 43.5 GiB) behind
            the gRPC server, EngineConfig(model="mixtral-8x7b",
            quantize=True), bf16 KV, the serve phase's requests and checks:
            flash, the bf16 decode and the bf16 write kernels must launch
            and no other; every decode block and prefill a graph replay.
            The capacity-bucketed dispatch drops by position in the batch,
            so the repeated greedy prompt is held to a solo run of it.
16a. mesh (mixtral): the same int8 weights (their first
            MESH_FEATURE_LAYERS layers) behind the mesh engine over a
            one-rank NCCL group: the capacity-bucketed MoE through
            moe_mlp_sharded's whole-batch routing (a group of one gathers
            nothing); MIXTRAL_MESH_PROMPTS one at a time (16 tokens), token
            for token the single-card engine of the same depth, every
            dispatch a replay, flash and the bf16 decode and write kernels
            launched.
17. serve-gemma: after Mixtral's weights are freed, gemma-2-2b (26 layers,
            random bf16 weights from seed + 2) is written as an HF
            safetensors checkpoint (two shards and an index, by this
            script's own writer) in a temporary directory, removed at the
            end. The full 46-layer gemma-2-27b (random bf16 weights from
            --seed, 50.72 GiB) is served over gRPC by EngineConfig(model=
            "gemma-2-27b"): the serve phase's requests and checks, then the
            spec phase's five greedy prompts over ExecuteToolStream; only
            flash, the bf16 decode and the bf16 write kernels launch, every
            block and prefill a replay. That engine is shut down, then the
            same target with the 2B draft loaded from its checkpoint
            (draft_checkpoint_path, gamma 4, top_p_candidates 64): the
            loaded draft must equal the one written bit for bit; the five
            greedy streams are held to the plain engine's texts under the
            spec phase's near-tie rule, then four sampled streams
            (temperature 0.8, top_p 0.9); every round a replay, no prefill
            eager, the decode and write kernels launched and no ragged
            kernel. It prints, beside the card's name and power limit, the
            weight bytes, both KV pools, the graph pool before and after
            the spec keys, the memory allocated and its peak, the
            checkpoint's bytes and load seconds, acceptance, rounds, tokens
            a lane a round, each request's TTFT, first streamed chunk,
            admission wait and tok/s against the plain engine. Before the
            plain engine stops, one supervised step-stall restart with its
            thread not wedged (a 2 s window, a 4 s stall): the dead
            engine's pools and graphs must be freed before the fresh one
            allocates its own (a second set does not fit beside 27B
            weights), the fresh engine serves on the same weight tensors,
            and the peak memory allocated during the restart is printed.

18. graphlint: last, with nothing else on the card (so its engines' capture
            streams and their cuBLAS workspaces come after every other
            phase's): the port's graphlint
            (polykey_tpu_torch/analysis/graph.py) with device="cuda" over
            its five engine modes (plain, spec, ragged, spec x ragged, host
            KV), each a single-card engine of MESH_FEATURE_LAYERS (4) of
            Llama-3-8B's layers at full width, bf16 weights drawn on the
            card from --seed (one set shared; the spec engines draft with
            the target itself), GRAPHLINT_CONFIG's geometry (4 slots, pages
            of 16, buckets 128 and 256, so flash serves the bucketed
            prefills). GL001 on the real captures: no capture after start,
            every replay's key captured, no kernel built; GL002 on the
            captured addresses and the graph pool's bytes; GL003 on one
            dispatch of each step; GL004 under
            torch.cuda.set_sync_debug_mode("error") and the host-sync guard,
            one engine at a time; GL005 abstract. Any finding outside the
            committed baseline (torch-graphlint-baseline.json) fails the
            run. It prints per engine the graphs captured and replayed, the
            crossing census by site and the guard's trips (0), each
            kernel's launches in the sweeps (flash, bf16 decode, the bf16
            write and bf16 ragged must be above 0) and the phase's wall.

The summary grades each serve request against the card's roofline
(engine/roofline.py: detect_chip must give the H100 SXM's spec): its
decode MBU (one lane's stream: the weights and its KV read once a token)
and its prefill MFU at TTFT, each at most 1.05 (a higher reading means a
byte or FLOP count is wrong).

The second-to-last line of standard output is the card's name and power
limit as nvidia-smi reports them; before it, one JSON line sums up each
kernel, its launches taken from the serve phase that runs it. The last
line is {"ok": true, "device": {...}}. Without a CUDA device, or without
the package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import queue
import statistics
import subprocess
import sys
import threading
import time
from dataclasses import replace

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM: published HBM3 rate
BF16_FLOPS_PER_S = 989e12       # H100 SXM: dense bf16 tensor-core peak


def phase_done(start: float):
    """A printer of the seconds since `start` at the end of each phase."""
    def done(name: str) -> None:
        say("timing", f"{name} ended at {time.monotonic() - start:.1f} s")
    return done


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def device_time_ms(fn, samples: int = 10, reps: int = 10) -> float:
    """Median over `samples` of the device time of one call of `fn`: each
    sample is a pair of CUDA events around `reps` back-to-back calls (which
    spreads the events' own cost). A sleep kernel holds the card while the
    host enqueues them all, so host launch overhead is not counted."""
    for _ in range(2):
        fn()
    sync()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(samples)]
    torch.cuda._sleep(100_000_000)
    for start, end in pairs:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
    sync()
    return statistics.median(start.elapsed_time(end) / reps for start, end in pairs)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(ok: bool, message: str) -> None:
    if not ok:
        raise AssertionError(message)


# -- phase 1 ---------------------------------------------------------------

def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    say("device", f"{name}, compute capability {cap[0]}.{cap[1]}, "
        f"{torch.cuda.device_count()} visible; nvidia-smi: {smi}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    check(cap == (9, 0), f"need compute capability 9.0 (sm_90a), got {cap}")
    return {"name": name, "smi": smi}


# -- phase 2 ---------------------------------------------------------------

def phase_build() -> None:
    from polykey_tpu_torch.ops import _build

    t0 = time.monotonic()
    _build.load_library()
    say("build", f"nvcc {' '.join(_build.NVCC_FLAGS)}: {len(_build._sources())} "
        f"sources built and loaded in {time.monotonic() - t0:.2f} s "
        f"(compile {_build.build_seconds:.2f} s)")
    for line in _build.build_log.splitlines():
        if (any(w in line for w in ("Compiling entry", "registers", "spill", "wgmma"))
                or line.startswith("==")):
            print(f"  ptxas {line.strip()}", file=sys.stderr)


# -- phase 2a: training -----------------------------------------------------

TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 6, 2, 512


def phase_train(seed: int, card: str) -> dict:
    """Train steps of the full Llama-3-8B through the port's training path
    over a one-rank NCCL group (module docstring, phase 2a). Returns the
    kernels' launches in the phase."""
    import math
    import socket

    import torch.distributed as dist

    from polykey_tpu_torch.engine.engine import KERNELS
    from polykey_tpu_torch.models.config import get_config
    from polykey_tpu_torch.models.quant import params_bytes
    from polykey_tpu_torch.models.transformer import init_params
    from polykey_tpu_torch.parallel.distributed import initialize_from_env, mesh_from_env
    from polykey_tpu_torch.train import make_train_step

    phase = "train"
    cfg = get_config("llama-3-8b")
    check(torch.cuda.memory_allocated() < 2**30,
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB already allocated")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {"POLYKEY_COORDINATOR": f"127.0.0.1:{port}", "POLYKEY_NUM_PROCESSES": "1",
           "POLYKEY_PROCESS_ID": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    state = None
    try:
        check(initialize_from_env(device="cuda"), "initialize_from_env brought nothing up")
        mesh = mesh_from_env(device="cuda")
        say(phase, f"process group: backend {dist.get_backend()}, world "
            f"{dist.get_world_size()}, coordinator {env['POLYKEY_COORDINATOR']}; mesh "
            f"{mesh.shape} on {mesh.device}")
        gen = torch.Generator(device="cuda").manual_seed(seed)
        t0 = time.monotonic()
        params = init_params(cfg, torch.bfloat16, "cuda", gen)
        n_params = params_bytes(params) // 2
        tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ), generator=gen,
                               device="cuda", dtype=torch.int32)
        targets = torch.roll(tokens, -1, dims=1)
        targets[:, -1] = -1
        positions = torch.arange(TRAIN_SEQ, dtype=torch.int32,
                                 device="cuda").expand(TRAIN_BATCH, -1).contiguous()
        init_state, train_step, shard_batch = make_train_step(cfg, mesh)
        state = init_state(params)
        del params
        batch = shard_batch(tokens, targets, positions)
        sync()
        say(phase, f"llama-3-8b, {cfg.num_layers} layers, {n_params / 1e9:.3f} B parameters "
            f"in bf16 ({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated) drawn in "
            f"{time.monotonic() - t0:.1f} s; batch {TRAIN_BATCH} x {TRAIN_SEQ}; optimizer "
            f"{type(state.optimizer).__name__} fused={state.optimizer.defaults['fused']}")
        for k in KERNELS.values():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        losses, walls = [], []
        for _ in range(TRAIN_STEPS):
            sync()
            t0 = time.monotonic()
            state, loss = train_step(state, *batch)
            losses.append(float(loss))
            sync()
            walls.append(time.monotonic() - t0)
        peak = torch.cuda.max_memory_allocated()
        profile = _train_profile(train_step, state, batch)
        counts = {name: k.launches for name, k in KERNELS.items()}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        state = None
        if dist.is_initialized():
            dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    tokens_step = TRAIN_BATCH * TRAIN_SEQ
    later = walls[1:]
    med = statistics.median(later)
    flops = 8 * cfg.num_params() * tokens_step
    say(phase, f"losses {[round(x, 4) for x in losses]} (ln {cfg.vocab_size} = "
        f"{math.log(cfg.vocab_size):.4f})")
    say(phase, f"step wall: first {walls[0] * 1e3:.1f} ms; steps 2-{TRAIN_STEPS} median "
        f"{med * 1e3:.1f} ms (range {min(later) * 1e3:.1f}-{max(later) * 1e3:.1f}); "
        f"{tokens_step / med:.0f} tokens/s; peak allocated {peak / 2**30:.2f} GiB; "
        f"model FLOPs {flops:.3e} a step, utilisation {flops / med / BF16_FLOPS_PER_S * 100:.1f}% "
        f"of the 989 TFLOP/s dense bf16 peak, on {card}")
    busy = sum(profile["parts"].values())
    say(phase, f"one more step under torch.profiler: {profile['kernels']} kernels, device "
        f"busy {busy:.1f} ms against the unprofiled median wall {med * 1e3:.1f} ms (idle "
        f"share {1 - busy / (med * 1e3):.3f}); by part (ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in profile["parts"].items()) + f" on {card}")
    for name, ms, n in profile["top"]:
        say(phase, f"  {ms:8.2f} ms  {n:5d} x  {name[:90]}")
    say(phase, f"kernel launches in this phase: {counts}")
    check(all(math.isfinite(x) for x in losses), f"a loss is not finite: {losses}")
    check(abs(losses[0] - math.log(cfg.vocab_size)) < 1.0,
          f"first loss {losses[0]:.4f} is not within 1.0 of ln(V)")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    check(all(n == 0 for n in counts.values()), f"a kernel launched in training: {counts}")
    left = torch.cuda.memory_allocated()
    say(phase, f"after the phase: {left / 2**30:.3f} GiB allocated, process group "
        f"destroyed")
    check(left < 2**30, f"{left / 2**30:.2f} GiB still allocated after the train phase")
    return {"launches": counts, "step_ms": med * 1e3, "losses": losses, "peak_gib": peak / 2**30}


TRAIN_PARTS = (                  # by kernel name, first match wins
    ("GEMMs", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
    ("optimizer", ("adam",)),
    ("collectives", ("nccl",)),
    ("softmax", ("softmax",)),
)


def _train_profile(train_step, state, batch) -> dict:
    """The device time of one train step by part (TRAIN_PARTS, the rest as
    "elementwise and other"), the kernel count and the 8 costliest
    kernels (name, ms, launches)."""
    import collections

    from polykey_tpu_torch.tools.profile_decode import device_kernels

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        train_step(state, *batch)
        sync()
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in device_kernels(prof):
        if getattr(e, "is_user_annotation", False):
            continue          # a range on the device's row (Optimizer.step), not a kernel
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    parts = {name: 0.0 for name, _ in TRAIN_PARTS}
    parts["elementwise and other"] = 0.0
    for name, (ms, _) in by_name.items():
        low = name.lower()
        part = next((p for p, keys in TRAIN_PARTS if any(k in low for k in keys)),
                    "elementwise and other")
        parts[part] += ms
    top = sorted(((n, ms, c) for n, (ms, c) in by_name.items()), key=lambda t: -t[1])[:8]
    return {"parts": parts, "top": top, "kernels": sum(c for _, c in by_name.values())}


# -- phase 3 ---------------------------------------------------------------

PAGE_SIZE, TABLE = 16, 256     # default EngineConfig: 4096 positions in pages of 16


def _randn(shape, gen, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _write_slots(gen, B, N, ps, P, pad):
    """Positions [B, 1] and tables [B, P] that send each of the first B - pad
    rows to its own slot (a random page and offset) and the last `pad` rows
    (inactive lanes, a stream's padding) to the garbage page 0 at position 0."""
    slots = torch.randperm((N - 1) * ps, generator=gen, device="cuda")[:B]
    positions = torch.randint(0, P * ps, (B, 1), generator=gen, device="cuda",
                              dtype=torch.int32)
    positions[:, 0] = positions[:, 0] - positions[:, 0] % ps + (slots % ps).to(torch.int32)
    tables = torch.zeros((B, P), dtype=torch.int32, device="cuda")
    rows = torch.arange(B, device="cuda")
    tables[rows, positions[:, 0].long() // ps] = (1 + slots // ps).to(torch.int32)
    tables[B - pad:] = 0
    positions[B - pad:] = 0
    return positions, tables


def _write_case(label, B, err, kernel, plain, library, nbytes) -> dict:
    """Time one write case (kernel, plain version, library call) beside its
    bound and the launch floor: an empty kernel timed back to back by the
    same method, the least any launch takes."""
    ms, plain_ms, lib = (device_time_ms(f) for f in (kernel, plain, library))
    floor = device_time_ms(lambda: torch.cuda._sleep(0))
    b_ms, b_by = bound_ms(nbytes, 0)
    say("kernels", f"{label}, B={B}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {lib:.4f} ms, bound {b_ms:.6f} ms ({b_by}), launch floor "
        f"{floor:.4f} ms")
    return {"rows": B, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by,
            "launch_floor_ms": floor}


# The kernel cases at Gemma-2's geometry: (label, Hq, Hk, D, scale), beside
# the D=64 draft lines; soft-cap 50 and window 4096 for both.
GEMMA_SHAPES = (("gemma-2-27b", 32, 16, 128, 144.0 ** -0.5),
                ("gemma-2-2b", 8, 4, 256, 256.0 ** -0.5))
GEMMA_CAP, GEMMA_WINDOW = 50.0, 4096
# A serving mesh's tp ranks (the mesh phase's kernel cases): (model, tp,
# local Hq, local Hk, soft-cap, window, (scale,) or ()), D 128.
MESH_SHAPES = (("llama-3-8b", 2, 16, 4, None, None, ()),
               ("llama-3-8b", 4, 8, 2, None, None, ()),
               ("gemma-2-27b", 2, 16, 8, GEMMA_CAP, GEMMA_WINDOW, (144.0 ** -0.5,)))


def _write_geometries():
    """(B, Hk, D, key) of the write cases: 16 lanes, a 1040-row stream,
    16 lanes of the 1B draft's pools (D=64) and of each Gemma pool, and 16
    lanes (a dp gather's whole batch) at a Llama-3-8B tp rank's kv heads."""
    return ([(16, 8, 128, None), (1040, 8, 128, "stream"), (16, 8, 64, "d64")]
            + [(16, hk, d, name) for name, _, hk, d, _ in GEMMA_SHAPES]
            + [(16, 8 // tp, 128, f"mesh llama-3-8b tp={tp}") for tp in (2, 4)])


def _write_result(cases: list) -> dict:
    """The 16-lane case first, the others under their keys (the Gemma and
    the mesh geometries as lists under "gemma" and "mesh")."""
    out = dict(cases[0][1])
    for key, case in cases[1:]:
        group = key.split()[0] if key.startswith(("gemma", "mesh")) else None
        if group is not None:
            out.setdefault("gemma" if group.startswith("gemma") else "mesh", []).append(
                {"case": key, **case})
        else:
            out[key] = case
    return out


def kernel_write(gen) -> dict:
    """B = 16 lanes into [2048, 16, 8, 128] pools, lanes 13-15 inactive on
    the garbage page 0; then the 1040 rows of a ragged stream, the last 3
    padding on page 0; then 16 lanes at D=64 (the 1B draft's pools) and at
    each Gemma-2 pool geometry (Hk 16, D 128; Hk 4, D 256)."""
    from polykey_tpu_torch.ops import paged_write_kernel as pw

    N, ps, P = 2048, 16, 256
    cases = []
    for B, Hk, D, key in _write_geometries():
        k_pool = _randn((N, ps, Hk, D), gen)
        v_pool = _randn((N, ps, Hk, D), gen)
        k_new = _randn((B, 1, Hk, D), gen)
        v_new = _randn((B, 1, Hk, D), gen)
        if B == 16 and D == 128 and Hk == 8:
            positions = torch.tensor(
                [0, 15, 16, 17, 100, 255, 256, 1000, 2047, 2048, 3000, 4095, 7, 0, 0, 0],
                dtype=torch.int32, device="cuda",
            ).reshape(B, 1)
            tables = torch.randint(1, N, (B, P), generator=gen, device="cuda",
                                   dtype=torch.int32)
            tables[13:] = 0
            # Distinct target pages, so no two active lanes write the same row.
            targets = torch.randperm(N - 1, generator=gen, device="cuda")[:13] + 1
            tables[torch.arange(13, device="cuda"), positions[:13, 0].long() // ps] = (
                targets.to(torch.int32))
        else:
            positions, tables = _write_slots(gen, B, N, ps, P, 3)
        kk, vk = k_pool.clone(), v_pool.clone()
        kp, vp = k_pool.clone(), v_pool.clone()
        pw.paged_write_decode_cuda(kk, vk, k_new, v_new, tables, positions)
        pw.paged_write_decode_plain(kp, vp, k_new, v_new, tables, positions)
        sync()
        # Exact on every page but the garbage page 0 (inactive lanes race there).
        err = max(
            (kk[1:].float() - kp[1:].float()).abs().max().item(),
            (vk[1:].float() - vp[1:].float()).abs().max().item(),
        )
        check(err == 0.0, f"paged write B={B} differs from plain by {err}")
        say("kernels", f"paged_write B={B} pools [{N},{ps},{Hk},{D}] bf16: max |err| "
            f"{err} (tolerance 0: a copy)")
        page_ids, offsets = pw._slots(tables, positions, ps)
        rows_k, rows_v = k_new[:, 0], v_new[:, 0]

        def library():
            kk.index_put_((page_ids, offsets), rows_k)
            vk.index_put_((page_ids, offsets), rows_v)

        row = Hk * D * 2
        cases.append((key, _write_case(
            f"paged_write Hk={Hk} D={D}{f' ({key})' if key else ''} (library: "
            "index_put_ x2)", B, err,
            lambda: pw.paged_write_decode_cuda(kk, vk, k_new, v_new, tables, positions),
            lambda: pw.paged_write_decode_plain(kp, vp, k_new, v_new, tables, positions),
            library,
            2 * 2 * B * row + 2 * B * 4)))      # rows read + written; index reads
    return _write_result(cases)


def kernel_write_int8(gen) -> dict:
    """The quantizing write: 16 decode lanes (lanes 13-15 inactive on page 0)
    and the 1040 rows of a ragged stream (the last 3 padding on page 0),
    into int8 [2048, 16, 8, 128] pools with bf16 scales, then 16 lanes at
    D=64 (the 1B draft's pools) and at each Gemma-2 pool geometry; exact
    against its plain version."""
    from polykey_tpu_torch.ops import paged_write_kernel as pw
    from polykey_tpu_torch.ops.paged_attention import quantize_kv_rows

    N, ps, P = 2048, 16, 256
    cases = []
    for B, Hk, D, key in _write_geometries():
        pools = [quantize_kv_rows(_randn((N, ps, Hk, D), gen)) for _ in range(2)]
        k_new, v_new = _randn((B, 1, Hk, D), gen), _randn((B, 1, Hk, D), gen)
        k_new[1] = 0.0                                   # an all-zero row
        positions, tables = _write_slots(gen, B, N, ps, P, 3)
        kern = [(v.clone(), s.clone()) for v, s in pools]
        plain = [(v.clone(), s.clone()) for v, s in pools]
        pw.paged_write_int8_cuda(*kern, k_new, v_new, tables, positions)
        pw.paged_write_int8_plain(*plain, k_new, v_new, tables, positions)
        sync()
        diff = [int((a[1:].view(torch.int8) != b[1:].view(torch.int8)).sum())
                for ka, kb in zip(kern, plain) for a, b in zip(ka, kb)]
        check(sum(diff) == 0, f"int8 write B={B} differs from plain in {diff} bytes")
        say("kernels", f"paged_write_int8 B={B} D={D} bf16 rows into int8 pools [{N},{ps},"
            f"{Hk},{D}] + bf16 scales: bytes differing from plain {sum(diff)} "
            "(tolerance 0: the quantizer is exact)")
        page_ids, offsets = pw._slots(tables, positions, ps)
        (kq, ks), (vq, vs) = kern

        def library():
            for (values, scales), new in (((kq, ks), k_new), ((vq, vs), v_new)):
                q8, sc = quantize_kv_rows(new[:, 0])
                values.index_put_((page_ids, offsets), q8)
                scales.index_put_((page_ids, offsets), sc)

        cases.append((key, _write_case(
            f"paged_write_int8 Hk={Hk} D={D}{f' ({key})' if key else ''} (library: "
            "quantize + index_put_ x4)", B, 0.0,
            lambda: pw.paged_write_int8_cuda(*kern, k_new, v_new, tables, positions),
            lambda: pw.paged_write_int8_plain(*plain, k_new, v_new, tables, positions),
            library,
            2 * B * Hk * D * 2 + 2 * B * Hk * (D + 2) + 2 * B * 4)))
    return _write_result(cases)


def _int8_pools(k_pool, v_pool, stale):
    """Quantize bf16 pools into (values, scales) pairs; `stale` [N, ps]
    rows are unwritten slots, whose scales hold NaN."""
    from polykey_tpu_torch.ops.paged_attention import quantize_kv_rows

    pairs = [quantize_kv_rows(torch.nan_to_num(p, nan=0.0)) for p in (k_pool, v_pool)]
    for _, scales in pairs:
        scales[stale] = float("nan")
    return pairs


def _decode_case(gen, D, Hq, Hk, ctx_lens, softcap, window, page_range, int8,
                 scale=None):
    from polykey_tpu_torch.ops import paged_attention_kernel as pak

    ps, P = PAGE_SIZE, TABLE
    B = len(ctx_lens)
    pages = [-(-n // ps) for n in ctx_lens]
    N = sum(pages) + 1
    k_pool = _randn((N, ps, Hk, D), gen)
    v_pool = _randn((N, ps, Hk, D), gen)
    # Stale K and V rows past each position hold NaN: masked rows must never
    # reach the sums (0 x NaN would poison them).
    tables = torch.zeros((B, P), dtype=torch.int32, device="cuda")
    order = (torch.randperm(N - 1, generator=gen, device="cuda") + 1).to(torch.int32)
    used = 0
    for b, (n, npg) in enumerate(zip(ctx_lens, pages)):
        tables[b, :npg] = order[used: used + npg]
        used += npg
        last = int(tables[b, npg - 1])
        tail = n - (npg - 1) * ps
        k_pool[last, tail:] = float("nan")
        v_pool[last, tail:] = float("nan")
    if int8:
        k_pool, v_pool = _int8_pools(k_pool, v_pool, torch.isnan(v_pool).any(-1).any(-1))
    q = _randn((B, Hq, D), gen)
    pos = torch.tensor([n - 1 for n in ctx_lens], dtype=torch.int32, device="cuda")
    kw = dict(scale=scale or D ** -0.5, logit_softcap=softcap, window=window,
              page_range=page_range)
    acc, m, l = pak.paged_decode_cuda(q, k_pool, v_pool, tables, pos, **kw)
    acc_p, m_p, l_p = pak.paged_decode_plain(q, k_pool, v_pool, tables, pos, **kw)
    tol = pak.decode_error_bound(q, k_pool, v_pool, tables, pos, **kw)
    sync()
    out = acc / torch.clamp(l, min=1e-9)
    out_p = acc_p / torch.clamp(l_p, min=1e-9)
    check(bool(torch.isfinite(out).all()), "decode kernel output is not finite")
    diff = (out - out_p).abs()
    err, err_m = diff.max().item(), (m - m_p).abs().max().item()
    ratio = (diff / tol).max().item()
    check(ratio <= 1.0 and err <= 2e-3 and err_m <= 1e-3,
          f"decode kernel differs from plain: out {err} (largest err/tol {ratio}), "
          f"m {err_m}")
    # Rows this run's data needs: [max(0, pos - window + 1), pos] within
    # the page range; each read once, plus the page ids of their pages.
    rlo, rhi = page_range or (0, P)
    split = pak.split_pages(ps, int8)
    visible = read_pages = busy_ctas = merged = 0
    for n in ctx_lens:
        first = max(n - window, 0) if window else 0
        rows = max(0, min(n, rhi * ps) - max(first, rlo * ps))
        visible += rows
        read_pages += -(-rows // ps)
        lo, hi = max(first // ps, rlo), min(-(-n // ps), rhi)
        splits = len({(p - rlo) // split for p in range(lo, hi)})
        busy_ctas += Hk * splits
        merged += Hk * (splits > 1)
    grid = Hk * B * max(1, -(-(rhi - rlo) // split))
    row = Hk * (D + 2) if int8 else Hk * D * 2      # one K or V row, scales incl.
    nbytes = (2 * visible * row + B * Hq * D * 2 + B * Hq * (D + 2) * 4
              + read_pages * 4 + B * 4)
    flops = 4 * Hq * D * visible
    ctas = (f"one launch: {busy_ctas} of the grid's {grid} CTAs hold rows and work "
            f"(the rest return at once); {merged} (sequence, kv head) merges in the launch")
    return (q, k_pool, v_pool, tables, pos, kw), (err, ratio), nbytes, flops, ctas


def kernel_decode(gen, int8: bool = False) -> dict:
    """The decode kernel, or with `int8` its int8 variant over pools
    quantized from the same kind of data (stale scales NaN)."""
    from polykey_tpu_torch.ops import paged_attention_kernel as pak

    # Context lengths over 1..4096 with page-boundary cases.
    ctx = [1, 15, 16, 17, 31, 33, 255, 256, 257, 1000, 1024, 2047, 2049,
           3001, 4095, 4096]
    cases = [
        ("main", 128, 32, 8, ctx, None, None, None),
        ("softcap 50, window 4096", 128, 32, 8, ctx, 50.0, 4096, None),
        ("window 1000", 128, 32, 8, ctx, None, 1000, None),
        ("D=64, the 1B draft's shape", 64, 32, 8, ctx, None, None, None),
        ("D=64 serve: 16 lanes at context 512", 64, 32, 8, [512] * 16, None, None,
         None),
        ("pages [3, 200)", 128, 32, 8, ctx, None, None, (3, 200)),
        ("serve: 16 lanes at context 512", 128, 32, 8, [512] * 16, None, None, None),
    ]
    # Gemma-2's geometries (bf16 KV only): group 2, its own query scale.
    gemma = [] if int8 else [
        (f"{name}, scale {scale:.5f}, softcap {GEMMA_CAP:g}, window {GEMMA_WINDOW}"
         f"{suffix}", D, Hq, Hk, lens, GEMMA_CAP, GEMMA_WINDOW, None, scale)
        for name, Hq, Hk, D, scale in GEMMA_SHAPES
        for suffix, lens in (("", ctx), (" serve: 16 lanes at context 512", [512] * 16))]
    # A serving mesh's tp ranks: their local heads (MESH_SHAPES).
    mesh = [(f"mesh {name} tp={tp} (Hq {Hq}, Hk {Hk}){suffix}", 128, Hq, Hk, lens, cap,
             win, None, *sc)
            for name, tp, Hq, Hk, cap, win, sc in MESH_SHAPES
            for suffix, lens in (("", ctx), (" serve: 16 lanes at context 512", [512] * 16))
            if lens is ctx or name == "llama-3-8b"]
    # The 1B draft's decode (D=64) at a tp=2 rank's heads.
    mesh += [(f"mesh llama-3.2-1b (the draft, D=64) tp=2 (Hq 16, Hk 4){suffix}", 64, 16, 4,
              lens, None, None, None)
             for suffix, lens in (("", ctx), (" serve: 16 lanes at context 512", [512] * 16))]
    result = None
    for label, D, Hq, Hk, lens, softcap, window, prange, *scale in cases + gemma + mesh:
        args, (err, ratio), nbytes, flops, ctas = _decode_case(
            gen, D, Hq, Hk, lens, softcap, window, prange, int8, *scale)
        q, kp, vp, tables, pos, kw = args
        ms = device_time_ms(lambda: pak.paged_decode_cuda(q, kp, vp, tables, pos, **kw))
        plain = device_time_ms(
            lambda: pak.paged_decode_plain(q, kp, vp, tables, pos, **kw), reps=2)
        b_ms, b_by = bound_ms(nbytes, flops)
        name = "paged_attention_decode_int8" if int8 else "paged_attention_decode"
        pools = "int8 pools + bf16 scales" if int8 else "bf16 pools"
        why = ("int8 values exact in fp16 on tensor cores, each probability times its "
               "V scale rounded to fp16 once, fp32 sums" if int8 else
               "bf16 q, K and V exact on tensor cores, each probability in two bf16 "
               "halves (bf16(p) and bf16(p - bf16(p)), within 2^-16 p), fp32 sums")
        say("kernels", f"{name} [{label}] B={len(lens)} Hq={Hq} "
            f"Hk={Hk} D={D} ps=16 P=256, {pools}, ctx {min(lens)}..{max(lens)}: "
            f"max |err| {err:.3e}, largest err/tol {ratio:.3f} (tolerance per element "
            "of the normalized output 2^-11 sum p|v| / l + 2^-25 sum |v8| / l + "
            f"1e-5 (1 + sum p|v| / l), and 2e-3 flat, 1e-3 on m: {why}); "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.6f} ms "
            f"({b_by}); {ctas}, on "
            f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
        if result is None:
            result = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                      "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "d64": [],
                      "gemma": []}
        else:
            result["max_abs_err"] = max(result["max_abs_err"], err)
        group = ("mesh" if label.startswith("mesh") else "gemma" if scale
                 else "d64" if D == 64 else None)
        if group is not None:
            result.setdefault(group, []).append(
                {"case": label, "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                 "bound_by": b_by, "max_abs_err": err, "err_over_tol": ratio})
    result["mesh"].append(_decode_sp2(gen, ctx, int8))
    return result


def _decode_sp2(gen, ctx, int8: bool) -> dict:
    """sp=2 decode as a mesh runs it: each half of the page table
    (sp_page_range) through the kernel, the two states merged
    (merge_split_states), against the plain version over the whole table
    under decode_error_bound and 2e-3; the lanes of up to 2048 rows leave
    the second half empty. The time is both halves' launches and the
    merge; the bound is the whole range's."""
    from polykey_tpu_torch.ops import paged_attention_kernel as pak

    name = "paged_attention_decode_int8" if int8 else "paged_attention_decode"
    args, _, nbytes, flops, _ = _decode_case(gen, 128, 32, 8, ctx, None, None, None, int8)
    q, kp, vp, tables, pos, kw = args
    halves = [pak.sp_page_range(TABLE, 2, s) for s in (0, 1)]

    def split_merged():
        return pak.merge_split_states(
            [pak.paged_decode_cuda(q, kp, vp, tables, pos, **dict(kw, page_range=r))
             for r in halves])

    acc, m, l = split_merged()
    acc_p, m_p, l_p = pak.paged_decode_plain(q, kp, vp, tables, pos, **kw)
    tol = pak.decode_error_bound(q, kp, vp, tables, pos, **kw)
    diff = (acc / torch.clamp(l, min=1e-9) - acc_p / torch.clamp(l_p, min=1e-9)).abs()
    err, ratio = diff.max().item(), (diff / tol).max().item()
    empty = sum(n <= halves[1][0] * PAGE_SIZE for n in ctx)
    check(ratio <= 1.0 and err <= 2e-3 and (m - m_p).abs().max().item() <= 1e-3,
          f"{name} sp=2 merge differs from the whole range: {err} (err/tol {ratio})")
    ms = device_time_ms(split_merged)
    plain = device_time_ms(lambda: pak.paged_decode_plain(q, kp, vp, tables, pos, **kw),
                           reps=2)
    b_ms, b_by = bound_ms(nbytes, flops)
    say("kernels", f"{name} [mesh sp=2: pages {halves[0]} and {halves[1]} merged] "
        f"B={len(ctx)} Hq=32 Hk=8 D=128, ctx {min(ctx)}..{max(ctx)} ({empty} lanes with "
        f"an empty second half): max |err| {err:.3e}, largest err/tol {ratio:.3f} "
        f"(decode_error_bound and 2e-3 flat, 1e-3 on m, against the whole range); "
        f"two launches + merge {ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.6f} ms "
        f"({b_by})")
    return {"case": "mesh sp=2 merge", "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": err, "err_over_tol": ratio}


def _sdpa(q, k, v, qpos, S, scale, window):
    """One library call over the same inputs, as a yardstick only."""
    import torch.nn.functional as F

    kv_pos = torch.arange(S, device="cuda")[None, None, :]
    mask = kv_pos <= qpos[:, :, None]
    if window:
        mask &= kv_pos > qpos[:, :, None] - window
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    groups = q.shape[2] // k.shape[2]
    kt = kt.repeat_interleave(groups, dim=1)
    vt = vt.repeat_interleave(groups, dim=1)
    m = mask[:, None]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m, scale=scale)


def _flash_positions(layout: str, B: int, T: int):
    """"mixed": row 0 prefills positions 0..T-1; row 1 a prompt that starts
    mid-window at 1000 and whose last quarter is padding (position -1).
    "chunk3": every row a 512-token chunk at positions 1024..1535, the
    third chunk of the serve's document. "sp2": every row the second of
    two sp ranks' query blocks of a 2T-token prefill, positions T..2T-1."""
    qpos = torch.arange(T, dtype=torch.int32, device="cuda")[None].repeat(B, 1)
    if layout == "chunk3":
        return qpos + 1024
    if layout == "sp2":
        return qpos + T
    qpos[1] += 1000
    qpos[1, T - T // 4:] = -1
    return qpos


def _nan_unseen(x, qpos, window):
    """NaN in every window row no query of its batch row sees (past the
    largest position, before the smallest one's window): stale slots."""
    x = x.clone()
    for b in range(x.shape[0]):
        valid = qpos[b][qpos[b] >= 0]
        x[b, int(valid.max()) + 1:] = float("nan")
        if window:
            x[b, :max(0, int(valid.min()) - window + 1)] = float("nan")
    return x


def kernel_flash(gen) -> dict:
    from polykey_tpu_torch.ops import flash_attention as fa

    cases = [
        ("main", 2, 512, 4096, 32, 8, 128, None, None, "mixed", False),
        ("T=128", 2, 128, 4096, 32, 8, 128, None, None, "mixed", False),
        ("softcap 50, window 1024", 2, 512, 4096, 32, 8, 128, 50.0, 1024, "mixed", False),
        ("D=64, the 1B draft's prefill", 2, 512, 4096, 32, 8, 64, None, None, "mixed",
         False),
        ("D=256", 2, 512, 4096, 16, 8, 256, None, None, "mixed", False),
        ("document chunk 3, positions 1024..1535", 1, 512, 4096, 32, 8, 128, None,
         None, "chunk3", False),
        ("short bucket", 4, 128, 4096, 32, 8, 128, None, None, "mixed", False),
        ("stale rows NaN, window 1024", 2, 512, 4096, 32, 8, 128, None, 1024, "mixed",
         True),
    ] + [
        (f"{name}, scale {scale:.5f}, softcap {GEMMA_CAP:g}, window {GEMMA_WINDOW}", 2,
         512, 4096, Hq, Hk, D, GEMMA_CAP, GEMMA_WINDOW, "mixed", False, scale)
        for name, Hq, Hk, D, scale in GEMMA_SHAPES
    ] + [
        ("mesh llama-3-8b tp=4 heads (Hq 8, Hk 2)", 2, 512, 4096, 8, 2, 128, None, None,
         "mixed", False),
        ("mesh sp=2: the second query block (positions 256..511) of a 512-token "
         "prefill against the whole window", 2, 256, 4096, 32, 8, 128, None, None,
         "sp2", False),
    ]
    result = None
    for label, B, T, S, Hq, Hk, D, softcap, window, layout, stale, *scale in cases:
        q = _randn((B, T, Hq, D), gen)
        k = _randn((B, S, Hk, D), gen)
        v = _randn((B, S, Hk, D), gen)
        qpos = _flash_positions(layout, B, T)
        scale = scale[0] if scale else None
        kw = dict(scale=scale or D ** -0.5, logit_softcap=softcap, window=window)
        # The stale case feeds the kernel NaN where no query looks and
        # holds it to the plain version over the same window with 0 there.
        if stale:
            kk, vk = _nan_unseen(k, qpos, window), _nan_unseen(v, qpos, window)
            k, v = torch.nan_to_num(kk, nan=0.0), torch.nan_to_num(vk, nan=0.0)
        else:
            kk, vk = k, v
        out = fa.flash_attention_cuda(q, kk, vk, qpos, **kw)
        ref = fa.flash_attention_plain(q, k, v, qpos, **kw).float()
        # Per element: each side rounds every probability and its output to
        # bf16 once (unit roundoff 2^-8), so the two may differ by
        # 2^-7 (|out| + sum_i p_i |v_i|); the second term is the plain
        # attention over |V|. 1e-4 covers fp32 sums in another order.
        ref_abs = fa.flash_attention_plain(q, k, v.abs(), qpos, **kw).float()
        tol = 2.0 ** -7 * (ref.abs() + ref_abs) + 1e-4
        sync()
        check(bool(torch.isfinite(out.float()).all()), f"flash [{label}] output is not finite")
        check(bool((out[qpos < 0] == 0).all()), f"flash [{label}] padding rows are not 0")
        diff = (out.float() - ref).abs()
        err = diff.max().item()
        # Each batch row apart, so the small outputs of long rows are held
        # to their own scale.
        ratio = [(diff[b] / tol[b]).max().item() for b in range(B)]
        check(max(ratio) <= 1.0, f"flash kernel [{label}] differs from plain beyond "
              f"tolerance: largest err/tol per batch row {ratio}")
        ms = device_time_ms(lambda: fa.flash_attention_cuda(q, kk, vk, qpos, **kw))
        plain = device_time_ms(lambda: fa.flash_attention_plain(q, k, v, qpos, **kw),
                               reps=2)
        lib = device_time_ms(_sdpa(q, k, v, qpos, S, kw["scale"], window), reps=2)
        # What this run's data needs: each query row sees keys [lo, p];
        # each batch row's K/V is read once over the union of those spans.
        p = qpos.long()
        valid = p >= 0
        lo = torch.clamp(p - window + 1, min=0) if window else torch.zeros_like(p)
        hi = torch.clamp(p, max=S - 1)
        visible = int(torch.where(valid, hi - lo + 1, torch.zeros_like(p)).sum())
        big = torch.full_like(p, S)
        kv_rows = sum(
            max(0, int(torch.where(valid[b], hi[b], -1).max())
                - int(torch.where(valid[b], lo[b], big[b]).min()) + 1)
            for b in range(B)
        )
        flops = 4 * D * Hq * visible
        nbytes = 2 * (2 * q.numel() + 2 * kv_rows * Hk * D) + qpos.numel() * 4
        b_ms, b_by = bound_ms(nbytes, flops)
        rows = ", ".join(f"{r:.3f}" for r in ratio)
        say("kernels", f"flash_attention [{label}] B={B} T={T} S={S} Hq={Hq} Hk={Hk} "
            f"D={D}: max |err| {err:.3e}, largest err/tol per batch row {rows} "
            "(tolerance per element 2^-7 (|ref| + "
            "sum p|v|) + 1e-4: bf16 probabilities and output rounded once on "
            "each side, fp32 accumulation in another order); kernel "
            f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
            f"{plain:.4f} ms, scaled_dot_product_attention {lib:.4f} ms, bound "
            f"{b_ms:.6f} ms ({b_by})")
        if result is None:
            result = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                      "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by, "d64": [],
                      "gemma": []}
        else:
            result["max_abs_err"] = max(result["max_abs_err"], err)
        group = ("mesh" if label.startswith("mesh") else "gemma" if scale
                 else "d64" if D == 64 else None)
        if group is not None:
            result.setdefault(group, []).append(
                {"case": label, "ms": ms, "plain_ms": plain, "library_ms": lib,
                 "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
                 "err_over_tol": max(ratio)})
    return result


def _ragged_case(gen, lens, kvs, T, empty, int8, Hq=32, Hk=8, D=128):
    """Ranges from row 0 in order, `empty` unused ranges past the stream,
    pools [2048, 16, Hk, D] bf16 with distinct pages per sequence and NaN
    in the unwritten V rows of each sequence's last page."""
    N, ps = 2048, PAGE_SIZE
    starts = [sum(lens[:i]) for i in range(len(lens))] + [T] * empty
    lens, kvs = list(lens) + [0] * empty, list(kvs) + [0] * empty
    k_pool = _randn((N, ps, Hk, D), gen)
    v_pool = _randn((N, ps, Hk, D), gen)
    tables = torch.zeros((len(lens), TABLE), dtype=torch.int32, device="cuda")
    order = (torch.randperm(N - 1, generator=gen, device="cuda") + 1).to(torch.int32)
    used = 0
    for s, kv in enumerate(kvs):
        npg = -(-kv // ps)
        if npg:
            tables[s, :npg] = order[used: used + npg]
            used += npg
            v_pool[int(tables[s, npg - 1]), kv - (npg - 1) * ps:] = float("nan")
    if int8:
        k_pool, v_pool = _int8_pools(k_pool, v_pool, torch.isnan(v_pool).any(-1).any(-1))
    q = _randn((T, Hq, D), gen)
    meta = [torch.tensor(x, dtype=torch.int32, device="cuda") for x in (starts, lens, kvs)]
    return (q, k_pool, v_pool, tables, *meta), (starts, lens, kvs)


def kernel_ragged(gen, int8: bool = False) -> dict:
    """The ragged kernel, or with `int8` its int8 variant over pools
    quantized from the same kind of data (stale scales NaN)."""
    from polykey_tpu_torch.ops import ragged_paged_attention_kernel as rk

    ctx = [1, 15, 16, 17, 31, 33, 255, 256, 257, 1000, 1024, 2047, 2049,
           3001, 4095, 4096]
    singles = [1] * len(ctx)
    # A ragged spec dispatch's stream (gamma 4): 16 verify windows of 5
    # rows, the last key of each at one of the contexts (at least 5), then
    # a first chunk (kv 512) and a second (kv 1024): T = 16 x 5 + 1024,
    # a multiple of the tile.
    windows, window_kvs = [5] * len(ctx), [max(c, 5) for c in ctx]
    spec = (windows + [512, 512], window_kvs + [512, 1024], 1104, 14, None, None)
    serve = (singles + [512, 512], [512] * 16 + [512, 1024], 1040, 14, None, None)
    cases = [
        # 16 decode singles, a first chunk (kv 512), a second chunk (kv 1024).
        ("main", singles + [512, 512], ctx + [512, 1024], 1040, 14, None, None),
        ("softcap 50, window 1024", singles + [512, 512], ctx + [512, 1024], 1040, 14,
         50.0, 1024),
        # A 300-token tail range at KV length 1800, 724 padding rows.
        ("tail + padding", singles + [300], ctx + [1800], 1040, 15, None, None),
        # profile_decode --ragged's dispatch: 16 lanes at context 512, a
        # first chunk (kv 512) and a second (kv 1024).
        ("serve: 16 lanes at context 512", *serve),
        # The main case's singles alone: the byte-bound part of the stream.
        ("singles: the main case's 16 alone", singles, ctx, 16, 16, None, None),
        # The spec stream through Llama-3-8B's layers, and through its
        # Llama-3.2-1B draft's (D 64, same heads).
        ("spec: 16 verify windows of 5 rows + two 512-row chunks", *spec),
        ("spec D=64 (the 1B draft): 16 verify windows of 5 rows + two 512-row chunks",
         *spec, 64),
    ]
    # A serving mesh's tp ranks (the mesh engine's ragged dispatches): the
    # serve case and the spec stream at a Llama-3-8B rank's local heads,
    # each cut into work items for those heads.
    cases += [(f"mesh llama-3-8b tp={tp} (Hq {32 // tp}, Hk {8 // tp}) {what}", *case, 128,
               32 // tp, 8 // tp)
              for tp in (2, 4) for what, case in (("serve: 16 lanes at context 512", serve),
                                                  ("spec stream", spec))]
    result = None
    for label, lens, kvs, T, empty, softcap, window, *shape in cases:
        D, Hq, Hk = list(shape) + [128, 32, 8][len(shape):]     # defaults: Llama-3-8B
        args, (starts, lens_, kvs_) = _ragged_case(gen, lens, kvs, T, empty, int8,
                                                   Hq, Hk, D)
        work = rk.ragged_work(starts, lens_, kvs_, T, Hq // Hk, Hk, "cuda")
        kw = dict(scale=D ** -0.5, logit_softcap=softcap, window=window)
        out = rk.ragged_attention_cuda(*args, work=work, **kw)
        ref = rk.ragged_attention_plain(*args, **kw)
        # Per element: the kernel rounds each probability to bf16 once (unit
        # roundoff 2^-8; for int8 the probability times its V scale, over
        # V values exact in bf16), so it may differ from the fp32 plain
        # version by 2^-8 sum p|v| / l over the (dequantized) V; the plain
        # attention over |V| gives that sum, and the factor 2 and 1e-4 cover
        # exp and fp32 sums in another order.
        v_abs = (args[2][0].abs(), args[2][1]) if int8 else args[2].abs()
        ref_abs = rk.ragged_attention_plain(*args[:2], v_abs, *args[3:], **kw)
        tol = 2.0 ** -7 * ref_abs + 1e-4
        sync()
        used = sum(lens)
        check(bool(torch.isfinite(out).all()), "ragged output is not finite")
        check(bool((out[used:] == 0).all()), "ragged padding rows are not 0")
        err = (out - ref).abs().max().item()
        ratio = ((out - ref).abs() / tol).max().item()
        check(ratio <= 1.0, f"ragged kernel differs from plain beyond tolerance: "
              f"largest err/tol {ratio}")
        ms = device_time_ms(lambda: rk.ragged_attention_cuda(*args, work=work, **kw))
        plain = device_time_ms(lambda: rk.ragged_attention_plain(*args, **kw), reps=2)
        # What this run's data needs: each query row sees keys
        # [max(0, p - window + 1), p]; each sequence's K and V rows are read
        # once over the union of its rows' spans.
        kv_rows = pairs = 0
        for st, ln, kv in zip(starts, lens_, kvs_):
            n = max(0, min(st + ln, T) - st)
            if n == 0:
                continue
            p0, p1 = kv - ln, kv - ln + n - 1
            lo = max(0, p0 - window + 1) if window else 0
            kv_rows += p1 + 1 - lo
            pairs += sum(min(p + 1, window) if window else p + 1
                         for p in range(p0, p1 + 1))
        row = Hk * (D + 2) if int8 else Hk * D * 2    # one K or V row, scales incl.
        nbytes = 2 * kv_rows * row + T * Hq * D * (2 + 4)
        flops = 4 * pairs * Hq * D
        b_ms, b_by = bound_ms(nbytes, flops)
        name = "ragged_paged_attention_int8" if int8 else "ragged_paged_attention"
        pools = "int8 pools + bf16 scales" if int8 else "bf16 pools"
        items = work.items.cpu()
        split = len({(s, r) for s, r, _, _, ns, _ in items.tolist() if ns > 1})
        say("kernels", f"{name} [{label}] T={T} Hq={Hq} Hk={Hk} "
            f"D={D} ps=16 P=256, {pools}, {len(items)} work items x {Hk} kv heads, "
            f"{split} split into {work.n_part} shares, merged in the launch: "
            f"max |err| {err:.3e}, largest err/tol "
            f"{ratio:.3f} (tolerance per element 2^-7 sum p|v| + 1e-4: the "
            "kernel rounds each probability to bf16 once, the fp32 plain "
            "version does not); padding rows 0; kernel "
            f"{ms:.4f} ms ({ms / b_ms:.1f}x the bound), plain {plain:.4f} ms, bound "
            f"{b_ms:.6f} ms ({b_by})")
        if result is None:
            result = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                      "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                      "spec": [], "d64": [], "mesh": []}
        else:
            result["max_abs_err"] = max(result["max_abs_err"], err)
        if label.startswith(("spec", "mesh")):
            group = "mesh" if label.startswith("mesh") else "d64" if D == 64 else "spec"
            result[group].append(
                {"case": label, "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                 "bound_by": b_by, "max_abs_err": err, "err_over_tol": ratio})
    return result


def phase_kernels(seed: int) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("kernels", "TF32 off for matmuls and cuDNN (allow_tf32 = False): plain "
        "versions run in full fp32 where they compute in fp32")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.inference_mode():
        results = {
            "paged_write": kernel_write(gen),
            "paged_attention_decode": kernel_decode(gen),
            "flash_attention": kernel_flash(gen),
            "ragged_paged_attention": kernel_ragged(gen),
            "paged_write_int8": kernel_write_int8(gen),
            "paged_attention_decode_int8": kernel_decode(gen, int8=True),
            "ragged_paged_attention_int8": kernel_ragged(gen, int8=True),
        }
    sync()
    return results


# -- phase 4 ---------------------------------------------------------------

class _PlainPath:
    """Route the forward passes through the plain versions with the
    reference's own kill switches."""

    NAMES = ("POLYKEY_DISABLE_FLASH", "POLYKEY_DISABLE_PAGED_KERNEL",
             "POLYKEY_DISABLE_RAGGED_KERNEL", "POLYKEY_DISABLE_KV_KERNEL")

    def __enter__(self):
        self.saved = {n: os.environ.get(n) for n in self.NAMES}
        for n in self.NAMES:
            os.environ[n] = "1"

    def __exit__(self, *exc):
        for n, v in self.saved.items():
            if v is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = v


def _launches() -> dict:
    from polykey_tpu_torch.engine.engine import KERNELS

    return {name: k.launches for name, k in KERNELS.items()}


def _slice_inputs(cfg, gen, B=2, T=128, steps=8, ps=16, P=256, lens=(100, 77),
                  start=0):
    """A right-padded prefill of B prompts (bucket T at positions start..,
    prompts of `lens` tokens past `start`; the `start` positions before it
    hold a history that prefills in chunks of T), `steps` forced decode
    tokens, and tables of pages of their own: (tokens [B, start + T],
    forced, tables, prompt lengths from position 0, pages per row, start)."""
    prompt_lens = [start + n for n in lens[:B]]
    tokens = torch.randint(3, 259, (B, start + T), generator=gen, device="cuda",
                           dtype=torch.int32)
    forced = torch.randint(3, 259, (steps, B), generator=gen, device="cuda",
                           dtype=torch.int32)
    tables = torch.zeros((B, P), dtype=torch.int32, device="cuda")
    per = -(-(start + T + steps) // ps)
    for b in range(B):
        tables[b, :per] = torch.arange(1 + b * per, 1 + (b + 1) * per)
    return tokens, forced, tables, prompt_lens, per, start


def _slice_run(cfg, params, inputs, int8=False):
    """Prefill (the history's chunks, then the bucket) then the forced
    decode steps through forward_paged: (logits of the sampled rows, every
    hidden state of the bucket and the steps)."""
    from polykey_tpu_torch.engine.kv_cache import init_paged_kv
    from polykey_tpu_torch.models.transformer import forward_paged, unembed

    tokens, forced, tables, prompt_lens, per, start = inputs
    B, T = tokens.shape[0], tokens.shape[1] - start
    paged = init_paged_kv(cfg, 1 + B * per, 16, torch.bfloat16, "cuda",
                          kv_dtype=torch.int8 if int8 else None)
    for c in range(0, start + T, T):
        positions = torch.arange(c, c + T, dtype=torch.int32, device="cuda")[None]
        hidden, paged = forward_paged(params, cfg, tokens[:, c:c + T],
                                      positions.repeat(B, 1), paged, tables)
    hiddens = [hidden.reshape(-1, hidden.shape[-1])]
    rows = torch.tensor([n - 1 - start for n in prompt_lens], device="cuda")
    logits = [unembed(params, cfg, hidden[torch.arange(B), rows])]
    for i in range(forced.shape[0]):
        pos = torch.tensor([[n + i] for n in prompt_lens], dtype=torch.int32,
                           device="cuda")
        hidden, paged = forward_paged(params, cfg, forced[i][:, None], pos,
                                      paged, tables)
        hiddens.append(hidden[:, 0])
        logits.append(unembed(params, cfg, hidden[:, 0]))
    sync()
    return torch.stack(logits), torch.cat(hiddens).float()


BUCKETED = ("flash_attention", "paged_attention_decode", "paged_write")
BUCKETED_INT8 = ("flash_attention", "paged_attention_decode_int8", "paged_write_int8")


def _kernels_vs_plain(label, cfg, params, inputs, int8=False, routing=None):
    """The slice through the kernels and through their plain versions:
    only the path's kernels launch, and only in the kernel run; the logits
    within 0.12 with the same argmax on every row. `routing` (a MoE
    model's _Routing) records the kernel run's experts and hands them to
    the plain run. Returns the kernel run's hidden states."""
    names = BUCKETED_INT8 if int8 else BUCKETED
    kernel_ctx = routing.record() if routing else contextlib.nullcontext()
    plain_ctx = routing.replay() if routing else contextlib.nullcontext()
    before = _launches()
    with kernel_ctx:
        got, hidden = _slice_run(cfg, params, inputs, int8)
    mid = _launches()
    with _PlainPath(), plain_ctx:
        want, _ = _slice_run(cfg, params, inputs, int8)
    after = _launches()
    if routing:
        routing.check(label)
    ran = {n: mid[n] - before[n] for n in mid if mid[n] > before[n]}
    check(set(ran) == set(names),
          f"the kernel run launched {ran}, not each of {names} alone")
    check(after == mid, f"the plain run launched kernels: {mid} -> {after}")
    check(bool(torch.isfinite(got).all()), "slice logits are not finite")
    err = (got - want).abs().max().item()
    rms = want.square().mean().sqrt().item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    tokens, forced, start = inputs[0], inputs[1], inputs[5]
    history = f"{start} positions of history in chunks, then " if start else ""
    say("slice", f"{label}, {'int8' if int8 else 'bf16'} KV: {history}prefill "
        f"T={tokens.shape[1] - start} (prompts {inputs[3]}) + {forced.shape[0]} "
        f"decode steps, kernels vs "
        f"plain: max |dlogit| {err:.4f} over logits of RMS {rms:.3f} "
        f"(tolerance 0.12, about twice the 0.055 measured on the H100 for "
        f"bf16 KV: bf16 activations round differently once attention sums "
        f"in another order); argmax agreement {agree:.3f} (must be 1); "
        f"kernel launches in the kernel run {ran}")
    check(err <= 0.12, f"{label}: slice logits differ by {err}")
    check(agree == 1.0, f"{label}: slice argmax agrees on only {agree:.3f} of the rows")
    return hidden


def phase_slice(seed: int) -> None:
    from polykey_tpu_torch.models.config import get_config
    from polykey_tpu_torch.models.transformer import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("slice", "TF32 off for matmuls and cuDNN (allow_tf32 = False)")
    cfg = replace(get_config("llama-3-8b"), num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, torch.bfloat16, "cuda", gen)
    inputs = _slice_inputs(cfg, gen)
    label = "llama-3-8b width, 2 layers, bf16 weights"
    with torch.inference_mode():
        hidden_bf16 = _kernels_vs_plain(label, cfg, params, inputs)
        hidden_int8 = _kernels_vs_plain(label, cfg, params, inputs, int8=True)
    _kv_gap("forward_paged", hidden_int8, hidden_bf16)
    _slice_ragged(cfg, params, gen)
    _slice_quantized_weights(cfg, params, inputs, hidden_bf16)
    del params
    torch.cuda.empty_cache()
    _slice_mixtral(seed)
    _slice_gemma(seed)


def _slice_quantized_weights(cfg, params, inputs, hidden_bf16) -> None:
    """The same slice with the weights quantized as the engine quantizes
    them (int8, and int4 in groups of 128), through the kernels, against
    the bf16 weights' hidden states under the reference's gate
    (tests/test_quant.py): the mean of |dh| / max(|h|, 1) under 0.05 for
    int8 and 0.35 for int4."""
    from polykey_tpu_torch.models.quant import params_bytes, quantize_params

    for bits, gate in ((8, 0.05), (4, 0.35)):
        qparams = quantize_params(params, cfg, bits=bits)
        with torch.inference_mode():
            before = _launches()
            _, hidden = _slice_run(cfg, qparams, inputs)
            after = _launches()
        ran = {n: after[n] - before[n] for n in after if after[n] > before[n]}
        check(set(ran) == set(BUCKETED), f"int{bits} weights: launched {ran}")
        check(bool(torch.isfinite(hidden).all()), f"int{bits} hidden not finite")
        rel = ((hidden - hidden_bf16).abs() / hidden_bf16.abs().clamp_min(1.0)).mean().item()
        say("slice", f"llama-3-8b width, 2 layers, int{bits} weights "
            f"({params_bytes(qparams) / 2**30:.3f} GiB against bf16 "
            f"{params_bytes(params) / 2**30:.3f}), bf16 KV, kernels, the same tokens: "
            f"mean |dh| / max(|h|, 1) against bf16 weights {rel:.5f} over "
            f"{hidden.shape[0]} hidden rows (gate {gate}, the reference's "
            f"int{bits} accuracy gate)")
        check(rel < gate, f"int{bits} weights: hidden gap {rel} against bf16")
        del qparams


class _Routing:
    """Top-k routing is a step function of the router logits: where two
    experts' logits are within the attention's bf16 rounding of a tie, the
    kernel and plain runs may pick different experts, and the token's MoE
    output changes by a whole expert (the first H100 run of the depth-2
    Mixtral slice: max |dlogit| 2.15, one argmax of 18 rows). So the plain
    run takes the kernel run's experts, weighted by its own logits
    (`replay`), and every token whose own top-k differs from them is a
    flip, whose margin (its own k-th logit minus its logit for the least
    of the recorded experts) must be a near-tie (NEAR_TIE, the spec
    phase's rule)."""

    def __init__(self):
        from polykey_tpu_torch.ops import moe

        self.moe, self.router = moe, moe._router_weights
        self.routes: list = []
        self.margins: list = []
        self.tokens = 0

    @contextlib.contextmanager
    def _swap(self, fn):
        self.moe._router_weights = fn
        try:
            yield
        finally:
            self.moe._router_weights = self.router

    def record(self):
        def recording(layer_params, h, cfg):
            combine, idx = self.router(layer_params, h, cfg)
            self.routes.append(idx)
            return combine, idx
        return self._swap(recording)

    def replay(self):
        recorded = iter(self.routes)

        def replaying(layer_params, h, cfg):
            idx = next(recorded)
            logits = h.float() @ layer_params["router"].float()
            kth = logits.topk(cfg.num_experts_per_tok, dim=-1).values[..., -1]
            chosen = logits.gather(-1, idx)
            margin = kth - chosen.min(-1).values        # > 0 where its own top-k differs
            self.margins.append(margin[margin > 0])
            self.tokens += idx.shape[0]
            combine = torch.zeros_like(logits).scatter_(-1, idx, torch.softmax(chosen, -1))
            return combine, idx
        return self._swap(replaying)

    def check(self, label: str) -> None:
        margins = torch.cat(self.margins) if self.margins else torch.zeros(0)
        worst = margins.max().item() if margins.numel() else 0.0
        say("slice", f"{label}: {margins.numel()} of {self.tokens} token routings of the "
            f"plain run differ from the kernel run's (held to the kernel run's); "
            f"largest margin {worst:.4f} (near-tie limit {NEAR_TIE})")
        check(worst <= NEAR_TIE, f"{label}: a routing flip with margin {worst}")


def _slice_mixtral(seed: int) -> None:
    """mixtral-8x7b at its published widths (8 experts, top-2, the
    capacity-bucketed dispatch), 2 layers, int8 weights drawn and
    quantized a layer at a time as the engine does: kernels against
    plain, the plain run on the kernel run's experts (_Routing)."""
    from polykey_tpu_torch.models.config import get_config
    from polykey_tpu_torch.models.quant import params_bytes
    from polykey_tpu_torch.models.transformer import init_params

    cfg = replace(get_config("mixtral-8x7b"), num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    params = init_params(cfg, torch.bfloat16, "cuda", gen, quantize_bits=8)
    inputs = _slice_inputs(cfg, gen)
    label = (f"mixtral-8x7b width ({cfg.num_experts} experts, top-{cfg.num_experts_per_tok}"
             f", dispatch), 2 layers, int8 weights {params_bytes(params) / 2**30:.3f} GiB")
    routing = _Routing()
    with torch.inference_mode():
        _kernels_vs_plain(label, cfg, params, inputs, routing=routing)
    del params
    torch.cuda.empty_cache()


def _slice_gemma(seed: int) -> None:
    """gemma-2-27b at its published widths (Hq 32, Hk 16, D 128, query
    scale 144^-0.5, soft-caps 50 and 30, window 4096), 2 layers: layer 0
    windowed, layer 1 global. On tables of 512 pages (max_seq_len 8192)
    positions 0..4095 prefill in eight 512-token chunks, then a 512-token
    bucket at 4096..4607 (prompts ending at 4596 and 4473) and 8 decode
    steps past it: the windowed layer's queries see only their last 4096
    keys. This is where the window bites on the card; the served engine
    (max_seq_len 4096) never gets there. Kernels against plain within 0.12
    with the same argmax on every row."""
    from polykey_tpu_torch.models.config import get_config
    from polykey_tpu_torch.models.transformer import init_params

    cfg = replace(get_config("gemma-2-27b"), num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    params = init_params(cfg, torch.bfloat16, "cuda", gen)
    start = cfg.sliding_window
    inputs = _slice_inputs(cfg, gen, T=512, P=8192 // PAGE_SIZE, lens=(500, 377),
                           start=start)
    label = (f"gemma-2-27b width (Hq {cfg.num_heads}, Hk {cfg.num_kv_heads}, D "
             f"{cfg.head_dim}, scale {cfg.q_scale:.5f}, window {cfg.sliding_window} on "
             f"layer 0), 2 layers, bf16 weights, past the window")
    with torch.inference_mode():
        _kernels_vs_plain(label, cfg, params, inputs)
    del params
    torch.cuda.empty_cache()


def _kv_gap(label: str, hidden_int8, hidden_bf16) -> None:
    """The reference's int8-KV accuracy gate (tests/test_kv_cache.py,
    test_forward_paged_int8_kv_tracks_fp): the largest hidden-state gap
    between int8 and bf16 KV on the same tokens, relative to the largest
    bf16 hidden value, under 0.05."""
    check(bool(torch.isfinite(hidden_int8).all()), f"{label} int8 hidden not finite")
    gap = ((hidden_int8 - hidden_bf16).abs().max()
           / (hidden_bf16.abs().max() + 1e-6)).item()
    say("slice", f"{label}, int8 KV vs bf16 KV on the same tokens, kernels: largest "
        f"|dh| / max |h| {gap:.5f} over {hidden_bf16.shape[0]} hidden rows "
        f"(tolerance 0.05, the reference's int8-KV accuracy gate)")
    check(gap < 0.05, f"{label}: int8 KV hidden states differ from bf16 by {gap}")


def _slice_ragged(cfg, params, gen) -> None:
    """Mixed prefill+decode through forward_ragged: a first dispatch
    prefills prompts A (100 tokens) and B (77); the next four decode A and
    B one token each, and the first of them also prefills prompt C (200
    tokens), which decodes in the last three. Logits of the rows that
    sample: kernels against plain, and against forward_paged over the same
    tokens (prefill per prompt, then batched decode steps)."""
    from polykey_tpu_torch.engine.kv_cache import init_paged_kv
    from polykey_tpu_torch.models.transformer import (
        forward_paged, forward_ragged, unembed,
    )
    from polykey_tpu_torch.ops import ragged_paged_attention_kernel as rk

    ps, P, steps = 16, 256, 4
    lens = {"A": 100, "B": 77, "C": 200}
    prompts = {k: torch.randint(3, 259, (n,), generator=gen, device="cuda",
                                dtype=torch.int32) for k, n in lens.items()}
    forced = torch.randint(3, 259, (steps, 3), generator=gen, device="cuda",
                           dtype=torch.int32)
    per = -(-(max(lens.values()) + steps) // ps)
    tables = {k: torch.zeros(P, dtype=torch.int32, device="cuda") for k in lens}
    for i, k in enumerate(lens):
        tables[k][:per] = torch.arange(1 + i * per, 1 + (i + 1) * per)
    num_pages = 1 + 3 * per

    def dispatches():
        """Per dispatch: [(seq, tokens, first position)] ranges."""
        out = [[("A", prompts["A"], 0), ("B", prompts["B"], 0)]]
        for i in range(steps):
            live = ["A", "B"] + (["C"] if i else [])
            ranges = [(k, forced[i, j:j + 1], lens[k] + i - (1 if k == "C" else 0))
                      for j, k in enumerate(live)]
            if i == 0:
                ranges.append(("C", prompts["C"], 0))
            out.append(ranges)
        return out

    def run_ragged(int8=False):
        paged = init_paged_kv(cfg, num_pages, ps, torch.bfloat16, "cuda",
                              kv_dtype=torch.int8 if int8 else None)
        logits, hiddens = [], []
        for ranges in dispatches():
            toks = torch.cat([t for _, t, _ in ranges])
            used = toks.shape[0]
            T = -(-used // rk.TOKEN_TILE) * rk.TOKEN_TILE
            tokens = torch.zeros(T, dtype=torch.int32, device="cuda")
            tokens[:used] = toks
            positions = torch.zeros(T, dtype=torch.int32, device="cuda")
            token_tables = torch.zeros((T, P), dtype=torch.int32, device="cuda")
            starts, seq_lens, kvs, rows = [], [], [], []
            off = 0
            for k, t, p0 in ranges:
                n = t.shape[0]
                positions[off:off + n] = torch.arange(p0, p0 + n)
                token_tables[off:off + n] = tables[k]
                starts.append(off)
                seq_lens.append(n)
                kvs.append(p0 + n)
                rows.append(off + n - 1)
                off += n
            meta = [torch.tensor(x, dtype=torch.int32, device="cuda")
                    for x in (starts, seq_lens, kvs)]
            seq_tables = torch.stack([tables[k] for k, _, _ in ranges])
            work = rk.ragged_work(starts, seq_lens, kvs, T,
                                  cfg.num_heads // cfg.num_kv_heads, cfg.num_kv_heads,
                                  "cuda")
            hidden, paged = forward_ragged(params, cfg, tokens, positions, paged,
                                           token_tables, *meta, seq_tables, work=work)
            logits.append(unembed(params, cfg, hidden[torch.tensor(rows, device="cuda")]))
            hiddens.append(hidden[:used])
        sync()
        return torch.cat(logits), torch.cat(hiddens).float()

    def run_paged():
        paged = init_paged_kv(cfg, num_pages, ps, torch.bfloat16, "cuda")
        logits = []
        for ranges in dispatches():
            rows = []
            singles = [(k, t, p0) for k, t, p0 in ranges if t.shape[0] == 1]
            if singles:
                hidden, paged = forward_paged(
                    params, cfg, torch.stack([t for _, t, _ in singles]),
                    torch.tensor([[p0] for _, _, p0 in singles], dtype=torch.int32,
                                 device="cuda"),
                    paged, torch.stack([tables[k] for k, _, _ in singles]))
                rows.append(hidden[:, 0])
            for k, t, p0 in ranges:
                if t.shape[0] > 1:
                    pos = torch.arange(p0, p0 + t.shape[0], dtype=torch.int32,
                                       device="cuda")[None]
                    hidden, paged = forward_paged(params, cfg, t[None], pos, paged,
                                                  tables[k][None])
                    rows.append(hidden[:, -1])
            logits.append(unembed(params, cfg, torch.cat(rows)))
        sync()
        return torch.cat(logits)

    with torch.inference_mode():
        before = _launches()
        got, hidden_bf16 = run_ragged()
        mid = _launches()
        with _PlainPath():
            want, _ = run_ragged()
        after = _launches()
        paged_ref = run_paged()
    name = "ragged_paged_attention"
    check(mid[name] > before[name] and mid["paged_write"] > before["paged_write"],
          f"the ragged kernel run skipped a kernel: {before} -> {mid}")
    check(after == mid, f"the plain ragged run launched kernels: {mid} -> {after}")
    check(bool(torch.isfinite(got).all()), "ragged slice logits are not finite")
    rms = want.square().mean().sqrt().item()
    for label, ref in (("plain forward_ragged", want), ("forward_paged", paged_ref)):
        err = (got - ref).abs().max().item()
        agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
        say("slice", f"llama-3-8b width, 2 layers, bf16, forward_ragged with kernels "
            f"vs {label}: 1 prefill dispatch (A 100, B 77 tokens) + {steps} mixed "
            f"dispatches (A, B decode; C 200-token prefill, then decode), "
            f"{got.shape[0]} sampled rows: max |dlogit| {err:.4f} over logits of RMS "
            f"{rms:.3f} (tolerance 0.12, the bucketed slice's bound); argmax "
            f"agreement {agree:.3f} (must be 1); ragged kernel launches "
            f"{mid[name] - before[name]} in the kernel run, "
            f"{after[name] - mid[name]} in the plain run")
        check(err <= 0.12, f"ragged slice logits differ from {label} by {err}")
        check(agree == 1.0, f"ragged slice argmax agrees with {label} on only "
              f"{agree:.3f} of the rows")

    # The same dispatches over int8 KV: the int8 ragged and write kernels
    # alone, against their plain versions and against bf16 KV.
    names8 = ("ragged_paged_attention_int8", "paged_write_int8")
    with torch.inference_mode():
        before = _launches()
        got8, hidden_int8 = run_ragged(int8=True)
        mid = _launches()
        with _PlainPath():
            want8, _ = run_ragged(int8=True)
        after = _launches()
    ran = {n: mid[n] - before[n] for n in mid if mid[n] > before[n]}
    check(set(ran) == set(names8), f"the int8 ragged run launched {ran}, not {names8}")
    check(after == mid, f"the plain int8 ragged run launched kernels: {mid} -> {after}")
    check(bool(torch.isfinite(got8).all()), "int8 ragged slice logits are not finite")
    err = (got8 - want8).abs().max().item()
    agree = (got8.argmax(-1) == want8.argmax(-1)).float().mean().item()
    say("slice", f"llama-3-8b width, 2 layers, bf16 weights, int8 KV, forward_ragged "
        f"with kernels vs plain, the same {steps + 1} dispatches: max |dlogit| "
        f"{err:.4f} over logits of RMS {want8.square().mean().sqrt().item():.3f} "
        f"(tolerance 0.12, the bf16 slices' bound); argmax agreement {agree:.3f} "
        f"(must be 1); kernel launches {ran}")
    check(err <= 0.12, f"int8 ragged slice logits differ from plain by {err}")
    check(agree == 1.0, f"int8 ragged slice argmax agrees on only {agree:.3f}")
    _kv_gap("forward_ragged", hidden_int8, hidden_bf16)


# -- phase 5 ---------------------------------------------------------------

SHORT = [
    "Summarize the tradeoffs between paged and contiguous KV caches for a "
    "batch of chat requests, briefly.",
    "List three reasons a decode step on a GPU is bound by memory traffic "
    "rather than by arithmetic.",
]
LONG = [
    ("Explain, step by step, how a continuous-batching inference server "
     "admits new requests while others are decoding: how it picks free "
     "slots, pads prompts to a bucket, writes their keys and values into "
     "pages, and then merges the new lanes into the running decode batch "
     "without stalling the requests that were already generating text. ") * 1
    + "Then say what limits the batch size on one card, and why.",
    ("A user sends a long document and asks for a short answer. Describe "
     "what happens to the prompt inside the engine: tokenization, the "
     "bucket it lands in, how many pages of the key/value pool it takes, "
     "how the prefill attends over its own window, and how the first "
     "token is sampled from the last hidden state of the prompt. Keep the "
     "description concrete and brief, and mention the cost. ") * 1,
]
# About 1500 tokens (the byte tokenizer: one per byte, plus BOS): past the
# largest bucket, so it prefills in three chunks of up to 512 tokens.
DOCUMENT = (
    "Section {}. The service keeps a pool of key and value pages on the card "
    "and gives each request a table of page ids; a prompt longer than the "
    "largest bucket prefills one chunk at a time while other requests go on "
    "decoding, and its first token is sampled from the last chunk. Pages "
    "return on finish. "
)
LONG_DOC = "".join(DOCUMENT.format(i) for i in range(5)) + "Summarize the document."


def _struct(**kv):
    from google.protobuf import struct_pb2

    s = struct_pb2.Struct()
    s.update(kv)
    return s


# The kernels each serve phase must launch; every other kernel must not.
SERVE_KERNELS = {
    (False, False): ("flash_attention", "paged_attention_decode", "paged_write"),
    (True, False): ("ragged_paged_attention", "paged_attention_decode", "paged_write"),
    (False, True): ("flash_attention", "paged_attention_decode_int8", "paged_write_int8"),
    (True, True): ("ragged_paged_attention_int8", "paged_attention_decode_int8",
                   "paged_write_int8"),
}


def phase_serve(seed: int, card: str, ragged: bool = False, params=None,
                int8: bool = False, model: str = "llama-3-8b", quantize: bool = False,
                phase: str = "", then=None, **config_kw) -> dict:
    """Serve `model` through gRPC. Bucketed (default) or ragged dispatch,
    over bf16 or (`int8`) int8 KV, with bf16 or (`quantize`) int8 weights;
    `params` reuses the weights of an earlier engine (shut down first).
    `then(grpc)` runs after the checks, before the server stops (its
    result is returned under "then"); `config_kw` are more EngineConfig
    fields."""
    from polykey_tpu_torch.engine.config import EngineConfig
    from polykey_tpu_torch.engine.engine import KERNELS, GenRequest, InferenceEngine

    phase = phase or ("ragged" if ragged else "serve") + ("-int8" if int8 else "")
    config = EngineConfig(model=model, ragged_dispatch=ragged,
                          kv_dtype="int8" if int8 else "", quantize=quantize, **config_kw)
    t0 = time.monotonic()
    engine = InferenceEngine(config, params=params, device="cuda", seed=seed)
    sync()
    nbytes = engine.stats()["weight_bytes"]
    kv = engine.paged.nbytes
    mode = (f"ragged dispatch, stream width {engine.stats()['ragged_width']} "
            f"(prefill budget {engine.stats()['prefill_budget']})" if ragged
            else f"buckets {config.prefill_buckets}, chunks of 512")
    say(phase, f"engine up in {time.monotonic() - t0:.1f} s: {config.model}, "
        f"{len(engine.params['layers'])} layers, {'int8' if quantize else 'bf16'} weights "
        f"{nbytes / 2**30:.2f} GiB (device memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB), KV pool {kv / 2**30:.4f} GiB ({engine.stats()['kv_dtype']}"
        f"{', scales included' if int8 else ''}; {config.num_pages} pages x "
        f"{config.page_size}), {config.max_decode_slots} slots, {mode}, decode "
        f"block {config.decode_block_steps}; native block allocator "
        f"{engine.allocator.is_native}")
    check(engine.allocator.is_native, "the engine is not on the native block allocator")
    # Keep each request the gateway submits, to read its timings after.
    grpc = _Grpc(engine)
    try:
        check(config.lookahead_blocks == 2 and config.adaptive_block,
              f"not the default pipeline: {config}")
        before = engine.stats()
        for k in KERNELS.values():
            k.launches = 0
        # A capacity-bucketed MoE (dispatch) drops by position in the batch
        # (GShard), so a request's tokens depend on what rides with it: its
        # repeat is held to a solo run below, not to its concurrent run.
        moe = engine.model_cfg.is_moe and engine.model_cfg.moe_dispatch
        results = _serve_requests(grpc.stub, grpc.pk, grpc.submitted,
                                  batch_invariant=not moe, engine=engine)
        counts = {name: k.launches for name, k in KERNELS.items()}
        stats = engine.stats()
        sync()
        say(phase, f"kernel launches in this phase: {counts}")
        replays = stats["decode_graph_replays"] - before["decode_graph_replays"]
        prefills = stats["prefill_graph_replays"] - before["prefill_graph_replays"]
        say(phase, f"graphs captured at start in {stats['graph_capture_s']:.2f} s: "
            f"{stats['decode_graph_captures']} decode, {stats['prefill_graph_captures']} "
            f"prefill, one pool of {stats['graph_pool_bytes'] / 2**20:.1f} MiB "
            f"(decode and prefill together) on {card}")
        say(phase, f"decode graphs: {replays} "
            f"replays in this phase; lookahead depth {stats['lookahead_depth']}, "
            f"observed max {stats['lookahead_observed_max']} (mean "
            f"{stats['lookahead_observed_mean']}; {stats['blocks_overlapped']} of "
            f"{stats['blocks_processed']} blocks overlapped); host stall p50 "
            f"{stats.get('host_stall_ms_p50', 'not measured')} ms, p95 "
            f"{stats.get('host_stall_ms_p95', 'not measured')} ms")
        check(stats["decode_graph_captures"] == 4,
              f"{stats['decode_graph_captures']} decode graphs captured, not 4")
        check(replays > 0, "no decode graph was replayed in this phase")
        layers = len(engine.params["layers"])
        if ragged:
            behind = (stats["ragged_behind_inflight"]
                      - before["ragged_behind_inflight"])
            say(phase, f"ragged dispatches: {stats['ragged_dispatches'] - before['ragged_dispatches']}"
                f" in this phase, {behind} of them dispatched with another block "
                f"in flight")
            check(behind > 0, "no ragged dispatch went out with another block in flight")
        else:
            eager = stats["prefill_eager"] - before["prefill_eager"]
            say(phase, f"prefill graphs: {prefills} replays in this phase, {eager} "
                f"prefills run eagerly; flash launches {counts['flash_attention']} "
                f"= {layers} layers x {counts['flash_attention'] / layers:.0f}")
            check(stats["prefill_graph_captures"] == 16,
                  f"{stats['prefill_graph_captures']} prefill graphs captured, not 16")
            check(prefills > 0 and eager == 0,
                  f"prefills: {prefills} graph replays, {eager} eager")
            # Flash runs only in the prefill: every launch came from a replay.
            check(counts["flash_attention"] == layers * prefills,
                  f"{counts['flash_attention']} flash launches for {prefills} prefill "
                  f"replays of {layers} layers")
        # The ragged modes' prefills ride the stream (flash 0); int8 KV
        # runs only the int8 variants, bf16 KV only the bf16 ones.
        want = SERVE_KERNELS[(ragged, int8)]
        check(all(counts[n] > 0 for n in want),
              f"a kernel of this path was not launched: {counts}")
        check(all(counts[n] == 0 for n in counts if n not in want),
              f"a kernel of another path was launched: {counts}")
        # Token-level determinism on the same engine: the gRPC text of a
        # random-weight model over a 128k vocab is mostly ids outside the
        # byte tokenizer's range, so compare the ids themselves too.
        ids = []
        for _ in range(2):
            req = GenRequest(prompt=SHORT[0], max_new_tokens=32)
            engine.submit(req)
            toks = []
            while True:
                kind, value = req.out.get(timeout=600)
                if kind == "token":
                    toks.append(value)
                elif kind == "error":
                    raise AssertionError(f"engine error: {value}")
                else:
                    break
            ids.append(toks)
        check(ids[0] == ids[1] and len(ids[0]) == 32,
              "a repeated greedy prompt gave other token ids")
        say(phase, f"repeated greedy prompt: identical 32 token ids "
            f"{ids[0][:8]}...")
        for r in results:
            say(phase, f"{r['label']}: status {r['status']}, prompt "
                f"{r['prompt_tokens']} tokens, {r['completion_tokens']} completion "
                f"tokens, TTFT {r['ttft_ms']:.1f} ms, {r['tok_s']:.1f} tok/s "
                f"(wall {r['wall_s']:.2f} s) on {card}")
        after = then(grpc) if then else None
        # The mesh phases' reference: the same streams, one at a time (the
        # ragged modes' without their engine, which nothing replays after).
        mesh_ref = None
        if phase == "serve":
            mesh_ref = {"ids": _mesh_reference(grpc, engine)["ids"]}
    finally:
        grpc.close()
    sync()
    return {"requests": results, "launches": counts, "params": engine.params,
            "kv_gib": kv / 2**30, "then": after, "mesh_ref": mesh_ref}


# -- phase 7a ---------------------------------------------------------------

MESH_PROMPTS = [SHORT[0], SHORT[1], LONG[0], LONG[1], LONG_DOC]


def _mesh_reference(grpc, engine) -> dict:
    """MESH_PROMPTS over streamed gRPC, greedy, 32 tokens, one request at a
    time (so every prefill runs alone: the same group pads, the same
    products, run after run): their token ids, the capture seconds, and
    the engine itself, whose graphs the mesh phase replays beside its own
    once this phase has shut the engine down."""
    ids = [grpc.generate([p], stream=True)[0][0] for p in MESH_PROMPTS]
    return {"ids": ids, "capture_s": engine.stats()["graph_capture_s"], "engine": engine}


def _replay_walls(engine, turns: int = 5) -> dict:
    """The median wall (CUDA events) of `turns` replays, after two untimed
    ones, of the 8-step greedy decode block's graph and of the 512-token
    prefill's (group pad 1, greedy, aligned), while the engine idles: every
    lane inactive, the prefill's fixed operands first set to the garbage
    page."""
    P = engine.config.pages_per_seq
    i32, f32 = np.int32, np.float32
    engine._prefill_ops[1].upload(
        np.zeros((1, 512), i32), np.zeros(1, i32), np.zeros(1, i32), np.zeros((1, P), i32),
        np.zeros((1, 2), i32), np.zeros(1, f32), np.ones(1, f32), np.zeros(1, i32))
    out = {}
    for key, graph in (("block_ms", ("decode", True, 8)),
                       ("prefill_ms", ("prefill", 512, 1, True, True))):
        walls = []
        for _ in range(2):
            engine._graphs.run(*graph)
        sync()
        for _ in range(turns):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            engine._graphs.run(*graph)
            b.record()
            b.synchronize()
            walls.append(a.elapsed_time(b))
        out[key] = statistics.median(walls)
    return out


def _replay_profile(engine) -> tuple:
    """One idle 8-step decode replay under torch.profiler: its device
    activities, and the copies among them (NCCL runs a one-rank collective
    as a copy, or as nothing when it is in place)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine._graphs.run("decode", True, 8)
        sync()
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    return len(names), sum("memcpy" in n.lower() for n in names)


def _walls_in_turns(single, mesh, rounds: int = 3) -> dict:
    """`_replay_walls` of the single-card engine and the mesh engine in
    turns (single, mesh, mesh, single, `rounds` times): {"single": [...],
    "mesh": [...]}, one result a turn."""
    out = {"single": [], "mesh": []}
    for _ in range(rounds):
        for name in ("single", "mesh", "mesh", "single"):
            out[name].append(_replay_walls(single if name == "single" else mesh))
    return out


@contextlib.contextmanager
def _count_captured_collectives():
    """Count the torch.distributed collectives issued while a stream
    captures (each one a node of the graph being captured)."""
    import torch.distributed as dist

    counts = {"all_reduce": 0, "all_gather": 0}
    saved = {name: getattr(dist, name) for name in counts}

    def counting(name, fn):
        def call(*args, **kwargs):
            if torch.cuda.is_current_stream_capturing():
                counts[name] += 1
            return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(dist, name, counting(name, fn))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


@contextlib.contextmanager
def _one_rank_nccl(phase: str):
    """A one-rank NCCL group brought up by initialize_from_env from the
    bootstrap variables (a free local port, one process), so the engines
    built inside take the mesh path; on the way out the variables are
    restored and the group destroyed, so the next engine finds none."""
    import socket

    import torch.distributed as dist

    from polykey_tpu_torch.parallel.distributed import initialize_from_env

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {"POLYKEY_COORDINATOR": f"127.0.0.1:{port}", "POLYKEY_NUM_PROCESSES": "1",
           "POLYKEY_PROCESS_ID": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        check(initialize_from_env(device="cuda"), "initialize_from_env brought nothing up")
        check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}, not nccl")
        nccl = ".".join(str(v) for v in torch.cuda.nccl.version())
        say(phase, f"process group: backend nccl {nccl}, world {dist.get_world_size()}, "
            f"coordinator {env['POLYKEY_COORDINATOR']}")
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if dist.is_initialized():
            dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    say(phase, "process group destroyed")


def phase_mesh(seed: int, params, card: str) -> dict:
    """The mesh engine on the serve phases' weights over a one-rank NCCL
    group (module docstring, phase 7a): at MESH_FEATURE_LAYERS layers, bf16
    and int8 KV, each beside a single-card engine of the same depth (served
    first, before the group is up; shut down but holding its graphs for the
    walls in turns); then the same depth read from a checkpoint, held to
    the bf16 single-card engine's one-at-a-time ids. Returns the kernels'
    launches in the bucketed sub-phases ("launches") and the checkpoint
    sub-phase ("checkpoint")."""
    import shutil

    from polykey_tpu_torch.engine.config import EngineConfig
    from polykey_tpu_torch.engine.engine import InferenceEngine

    phase = "mesh"
    model, cut = _cut_depth(params, MESH_FEATURE_LAYERS)
    singles, refs = {}, {}
    launches = {}
    ckpt = None
    try:
        for int8 in (False, True):
            grpc = _Grpc(InferenceEngine(EngineConfig(model=model,
                                                      kv_dtype="int8" if int8 else ""),
                                         params=cut, device="cuda", seed=seed))
            try:
                refs[int8] = _mesh_reference(grpc, grpc.engine)
            finally:
                grpc.close()
            singles[int8] = refs[int8].pop("engine")
        check(all(e.mesh is None for e in singles.values()), "a single-card engine took a mesh")
        ckpt = _write_checkpoint(cut, model, card)
        with _one_rank_nccl(phase):
            for int8 in (False, True):
                launches_of = _mesh_bucketed(seed, cut, card, refs[int8], singles, int8)
                for name, n in launches_of.items():
                    launches[name] = launches.get(name, 0) + n
            checkpoint = _mesh_checkpoint(seed, model, cut, card, ckpt, refs[False]["ids"])
    finally:
        for engine in singles.values():
            engine.release_device_state()
        singles.clear()
        if ckpt is not None:
            shutil.rmtree(ckpt["dir"], ignore_errors=True)
    return {"launches": launches, "checkpoint": checkpoint}


def _mesh_checkpoint(seed: int, model: str, params, card: str, ckpt: dict,
                     want: list) -> dict:
    """Phase 7a's checkpoint sub-phase: the bf16 mesh engine of `model` (at
    MESH_FEATURE_LAYERS layers) reading `params` from `ckpt` as its rank's
    shard (`_checkpoint_engine`), MESH_PROMPTS one at a time over gRPC
    token for token the single-card engine's of the same depth (`want`).
    Returns the kernels' launches."""
    from polykey_tpu_torch.engine.config import EngineConfig
    from polykey_tpu_torch.engine.engine import KERNELS

    label = (f"checkpoint, {MESH_FEATURE_LAYERS} layers, bf16 weights read as the "
             f"rank's shard")
    config = EngineConfig(model=model, checkpoint_path=ckpt["dir"])
    engine, _, up = _checkpoint_engine(config, params, seed, card, ckpt, label)
    grpc = _Grpc(engine)
    try:
        for k in KERNELS.values():
            k.launches = 0
        ids = [grpc.generate([p], stream=True)[0][0] for p in MESH_PROMPTS]
        counts = {name: k.launches for name, k in KERNELS.items()}
    finally:
        grpc.close()
    say("mesh", f"{label}: engine up in {up:.1f} s; kernel launches {counts} on {card}")
    _hold_mesh_ids(label, MESH_PROMPTS, ids, want, "the single-card engine's")
    check(all(counts[n] > 0 for n in ("flash_attention", "paged_attention_decode",
                                      "paged_write")),
          f"{label}: a kernel was not launched: {counts}")
    del engine, grpc
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _write_checkpoint(params, model: str, card: str) -> dict:
    """`model`'s bf16 weights `params` written as an HF checkpoint (this
    script's writer, two shards and an index) in a temporary directory."""
    import tempfile

    from polykey_tpu_torch.models.config import get_config

    ckpt = tempfile.mkdtemp(prefix=f"polykey-{model}-", dir=tempfile.gettempdir())
    t0 = time.monotonic()
    nbytes = write_hf_checkpoint(params, get_config(model), ckpt)
    say("mesh", f"checkpoint: {nbytes} bytes written in {time.monotonic() - t0:.1f} s "
        f"on {card}")
    return {"dir": ckpt, "bytes": nbytes}


def _checkpoint_engine(config, params, seed: int, card: str, ckpt: dict, label: str):
    """Phase 7a's bf16 mesh engine read from the checkpoint `ckpt`
    (`config` with its checkpoint_path): each tensor read as the rank's
    shard (models/loader.py with the mesh; all of it on a group of one).
    Prints the load's seconds, bytes and peak device memory above what was
    allocated before it, and checks the tree bit for bit the serve
    weights written. Returns `_mesh_engine`'s triple."""
    from polykey_tpu_torch.engine import engine as engine_mod
    from polykey_tpu_torch.engine.engine import InferenceEngine

    loads = []
    load = engine_mod.load_checkpoint

    def timed_load(*args, **kwargs):
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        counts = kwargs.setdefault("counts", {})
        t0 = time.monotonic()
        tree = load(*args, **kwargs)
        sync()
        loads.append({"s": time.monotonic() - t0, "counts": dict(counts), "base": base,
                      "peak": torch.cuda.max_memory_allocated() - base,
                      "mesh": kwargs.get("mesh")})
        return tree

    engine_mod.load_checkpoint = timed_load
    try:
        t0 = time.monotonic()
        with _count_captured_collectives() as captured:
            engine = InferenceEngine(config, device="cuda", seed=seed)
        up = time.monotonic() - t0
    finally:
        engine_mod.load_checkpoint = load
    check(len(loads) == 1 and loads[0]["mesh"] is engine.mesh and engine.mesh is not None
          and engine.stats()["mesh"]["world"] == 1,
          f"{label}: the engine did not read its checkpoint over its mesh: {loads}")
    pairs = list(zip(_leaves_of(engine.params), _leaves_of(params)))
    check(all(a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
              for a, b in pairs), f"{label}: a tensor read differs from the one written")
    info = loads[0]
    say("mesh", f"{label}: read from the checkpoint in {info['s']:.2f} s "
        f"({info['counts']['copied']} bytes copied as the rank's shards, "
        f"{info['counts']['scanned']} scanned for scales), peak device memory of the load "
        f"{info['peak'] / 2**30:.3f} GiB above the {info['base'] / 2**30:.2f} GiB allocated "
        f"before it; {len(pairs)} tensors "
        f"({sum(a.numel() * a.element_size() for a, _ in pairs)} bytes) bit for bit the "
        f"serve weights written, on {card}")
    check(info["counts"]["copied"] == ckpt["bytes"], f"{label}: {info['counts']} against "
          f"{ckpt['bytes']} bytes written (a rank of a group of one reads everything)")
    return engine, captured, up


def _mesh_engine(config, params, seed: int, label: str):
    """The mesh engine of `config` on `params` over the one-rank group,
    checked to have taken the mesh path on the caller's weight tensors;
    returns (engine, the collectives its captures issued, seconds to up)."""
    from polykey_tpu_torch.engine.engine import InferenceEngine

    t0 = time.monotonic()
    with _count_captured_collectives() as captured:
        engine = InferenceEngine(config, params=params, device="cuda", seed=seed)
    up = time.monotonic() - t0
    stats = engine.stats()
    check(engine.mesh is not None and stats["mesh"]["world"] == 1
          and stats["mesh"]["role"] == "leader",
          f"{label}: the engine did not take the mesh path: {stats.get('mesh')}")
    def storage(leaf):              # a quantized leaf's int8 values
        return getattr(leaf, "q", leaf).data_ptr()

    check(storage(engine.params["embed"]) == storage(params["embed"]),
          f"{label}: a group of one copied the weights")
    return engine, captured, up


def _mesh_bucketed(seed: int, params, card: str, ref: dict, singles: dict,
                   int8: bool) -> dict:
    """Phase 7a over one KV type: the bucketed mesh engine's streams, replay
    walls in turns with the single-card engine's, captured collectives;
    `params` are the single-card engine's (a cut of the serve weights)."""
    from polykey_tpu_torch.engine.config import EngineConfig
    from polykey_tpu_torch.engine.engine import KERNELS

    phase = "mesh"
    kv = "int8 KV" if int8 else "bf16 KV"
    config = EngineConfig(model=singles[int8].config.model, kv_dtype="int8" if int8 else "")
    engine, captured, up = _mesh_engine(config, params, seed, kv)
    weights = "the single-card engine's weight tensors (no copy)"
    stats = engine.stats()
    say(phase, f"{kv}: mesh engine up in {up:.1f} s over {stats['mesh']}, "
        f"{weights}, KV pool "
        f"{stats['kv_pool_bytes'] / 2**30:.4f} GiB; graphs captured in "
        f"{stats['graph_capture_s']:.2f} s ({stats['decode_graph_captures']} decode, "
        f"{stats['prefill_graph_captures']} prefill; the single-card engine's capture "
        f"{ref['capture_s']:.2f} s), pool {stats['graph_pool_bytes'] / 2**20:.1f} MiB "
        f"on {card}")
    grpc = _Grpc(engine)
    try:
        for k in KERNELS.values():
            k.launches = 0
        ids = [grpc.generate([p], stream=True)[0][0] for p in MESH_PROMPTS]
        counts = {name: k.launches for name, k in KERNELS.items()}
        after = engine.stats()
        turns = _walls_in_turns(singles[int8], engine)
        profiles = [_replay_profile(e) for e in (engine, singles[int8])]
    finally:
        grpc.close()
        singles.pop(int8).release_device_state()
    say(phase, f"{kv}: kernel launches {counts}")
    say(phase, f"{kv}: decode graph replays {after['decode_graph_replays']}, prefill "
        f"graph replays {after['prefill_graph_replays']}, prefills run eagerly "
        f"{after['prefill_eager']}")
    for key, label in (("block_ms", "8-step decode block"),
                       ("prefill_ms", "512-token prefill")):
        a = [t[key] for t in turns["mesh"]]
        b = [t[key] for t in turns["single"]]
        ma, mb = statistics.median(a), statistics.median(b)
        say(phase, f"{kv}: {label} replay wall at idle, in turns (single, mesh, "
            f"mesh, single) x 3, each turn the median of 5 replays: mesh "
            f"{ma:.3f} ms (turns {min(a):.3f}-{max(a):.3f}), single-card engine "
            f"{mb:.3f} ms ({min(b):.3f}-{max(b):.3f}): {(ma / mb - 1) * 100:+.2f}%, "
            f"the captured collectives over a group of one, on {card}")
    # Per step: the embedding's sum, two sums a layer, the logits'
    # gather; the decode keys run 2 x (8 + 1) steps, each of the 16
    # prefill keys one forward.
    layers = engine.model_cfg.num_layers
    want_calls = (2 * (8 + 1) + 16) * (2 + 2 * layers)
    say(phase, f"{kv}: collectives issued inside the graph captures: "
        f"{captured['all_reduce']} all-reduces, {captured['all_gather']} all-gathers "
        f"({want_calls} expected: {2 + 2 * layers} a forward over 34 forwards); one "
        f"decode replay under torch.profiler: {profiles[0][0]} device "
        f"activities, {profiles[0][1]} of them copies (the single-card "
        f"engine's: {profiles[1][0]}, {profiles[1][1]})")
    _hold_mesh_ids(kv, MESH_PROMPTS, ids, ref["ids"], "the single-card engine's")
    check(after["decode_graph_replays"] > 0 and after["prefill_graph_replays"] > 0
          and after["prefill_eager"] == 0,
          f"{kv}: decode or prefill not all graph replays: {after}")
    check(captured["all_reduce"] + captured["all_gather"] == want_calls,
          f"{kv}: {captured} collectives captured, not {want_calls}")
    want = ("flash_attention",) + (("paged_attention_decode_int8", "paged_write_int8")
                                   if int8 else ("paged_attention_decode", "paged_write"))
    check(all(counts[n] > 0 for n in want), f"{kv}: a kernel was not launched: {counts}")
    del engine, grpc
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _hold_mesh_ids(label: str, prompts: list, got: list, want: list, against: str,
                   explain=None) -> None:
    """The mesh engine's streams token for token the single-card ones; on a
    difference `explain(prompt, position, got, want)` adds to the message
    (the spec sub-phases: the two tokens' near-tie margin)."""
    for prompt, g, w in zip(prompts, got, want):
        if g != w and explain is not None:
            i = next(j for j, (x, y) in enumerate(zip(g + [None], w + [None])) if x != y)
            if i < min(len(g), len(w)):
                say("mesh", f"{label}: differs at generated token {i}: "
                    f"{explain(prompt, i, g, w)}")
        check(g == w, f"{label}: the mesh stream of a {len(prompt)}-character prompt "
              f"differs from {against}: {g} against {w}")
    check(len(got) == len(want), f"{label}: {len(got)} streams, not {len(want)}")
    say("mesh", f"{label}: all {len(got)} greedy streams token for token {against} "
        f"({sum(len(i) for i in got)} tokens)")


# -- phase 7b ---------------------------------------------------------------

def phase_orbax(seed: int, params, card: str, want: list) -> dict:
    """Phase 7b alone (`orbax_engine`, which the spec phase's plain bf16
    engine comes from in a whole run). Returns the kernels' launches."""
    out: dict = {}
    with orbax_engine(seed, params, card, want, out):
        pass
    return out["launches"]


@contextlib.contextmanager
def orbax_engine(seed: int, params, card: str, want: list, out: dict):
    """The reference's own checkpoint format on the card (module docstring,
    phase 7b): the serve weights (the full 32-layer Llama-3-8B) written by
    the port's `save_checkpoint` as an orbax directory (OCDBT + zarr +
    zstd, raw-block frames) in a temporary directory, then a single-card
    InferenceEngine (the default EngineConfig) from it as its
    `checkpoint_path`: the tree bit for bit the serve weights, MESH_PROMPTS
    one at a time over gRPC token for token `want` (the bf16 serve
    phase's), and flash, the paged write and the paged decode launched from
    it (`out["launches"]`). Yields the engine behind gRPC (`_Grpc`) for the
    caller's own requests; the directory is removed at the end."""
    import shutil
    import tempfile

    from polykey_tpu_torch.engine import engine as engine_mod
    from polykey_tpu_torch.engine.config import EngineConfig
    from polykey_tpu_torch.engine.engine import KERNELS, InferenceEngine
    from polykey_tpu_torch.models.loader import save_checkpoint
    from polykey_tpu_torch.models.quant import params_bytes

    from polykey_tpu_torch.ops._build import load_codec

    phase, label = "orbax", "orbax checkpoint, full depth, single card"
    t_phase = time.monotonic()
    load_codec()            # the host codec, built here, outside the timed write
    say(phase, f"checkpoint codec (csrc/checkpoint_codec.cc) built and loaded in "
        f"{time.monotonic() - t_phase:.2f} s")
    nbytes = params_bytes(params)
    free = shutil.disk_usage(tempfile.gettempdir()).free
    check(free > nbytes * 1.05 + 2**30, f"{phase}: {free} bytes free under "
          f"{tempfile.gettempdir()}, the checkpoint needs {nbytes} (plus framing)")
    root = tempfile.mkdtemp(prefix="polykey-orbax-", dir=tempfile.gettempdir())
    path = os.path.join(root, "llama-3-8b")
    engine = grpc = None
    try:
        sync()
        t0 = time.monotonic()
        written = save_checkpoint(path, params)
        write_s = time.monotonic() - t0
        on_disk = sum(os.path.getsize(os.path.join(d, f))
                      for d, _, files in os.walk(path) for f in files)
        say(phase, f"save_checkpoint: {on_disk} bytes on disk ({written} of chunk frames "
            f"for {nbytes} bytes of weights) in {write_s:.2f} s on {card}")
        loads = []
        load = engine_mod.load_checkpoint

        def timed_load(*args, **kwargs):
            sync()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            counts = kwargs.setdefault("counts", {})
            t1 = time.monotonic()
            tree = load(*args, **kwargs)
            sync()
            loads.append({"s": time.monotonic() - t1, "counts": dict(counts), "base": base,
                          "peak": torch.cuda.max_memory_allocated() - base})
            return tree

        engine_mod.load_checkpoint = timed_load
        try:
            t0 = time.monotonic()
            engine = InferenceEngine(EngineConfig(model="llama-3-8b", checkpoint_path=path),
                                     device="cuda", seed=seed)
            up = time.monotonic() - t0
        finally:
            engine_mod.load_checkpoint = load
        check(len(loads) == 1 and engine.mesh is None,
              f"{label}: the engine did not read its checkpoint once, alone: {loads}")
        info = loads[0]
        pairs = list(zip(_leaves_of(engine.params), _leaves_of(params)))
        check(len(pairs) == len(_leaves_of(params)) and all(
            a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
            for a, b in pairs), f"{label}: a tensor read differs from the one written")
        say(phase, f"{label}: engine up in {up:.1f} s, the read {info['s']:.2f} s "
            f"({info['counts']['decoded']} bytes decoded, {info['counts']['copied']} "
            f"copied to the card), peak device memory of the load "
            f"{info['peak'] / 2**30:.3f} GiB above the {info['base'] / 2**30:.2f} GiB "
            f"allocated before it; {len(pairs)} tensors bit for bit the serve weights "
            f"on {card}")
        check(info["counts"]["copied"] == info["counts"]["decoded"] == nbytes,
              f"{label}: {info['counts']} against {nbytes} bytes of weights")
        grpc = _Grpc(engine)
        for k in KERNELS.values():
            k.launches = 0
        t0 = time.monotonic()
        ids = [grpc.generate([p], stream=True)[0][0] for p in MESH_PROMPTS]
        serve_s = time.monotonic() - t0
        counts = {name: k.launches for name, k in KERNELS.items()}
        say(phase, f"{label}: {len(MESH_PROMPTS)} greedy prompts one at a time in "
            f"{serve_s:.2f} s; kernel launches {counts} on {card}")
        _hold_mesh_ids(label, MESH_PROMPTS, ids, want, "the serve phase's")
        check(all(counts[n] > 0 for n in ("flash_attention", "paged_attention_decode",
                                          "paged_write")),
              f"{label}: a kernel was not launched: {counts}")
        out["launches"] = counts
        say(phase, f"wall {time.monotonic() - t_phase:.1f} s (write, read, capture, serve)")
        yield grpc
    finally:
        if grpc is not None:
            grpc.close()
        elif engine is not None:
            engine.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    del engine, grpc
    gc.collect()
    torch.cuda.empty_cache()


# -- phases 14a and 15a ------------------------------------------------------

def phase_mesh_replicas(seed: int, params, card: str) -> dict:
    """Phase 14a: two Llama-3-8B replicas (at MESH_FEATURE_LAYERS layers)
    built of meshes over a one-rank NCCL group: each replica's engine on a
    serving mesh of its own (its own data, control and pages groups), both
    on the serve phases' weight tensors; MESH_PROMPTS one at a time, each
    replica serving them in turn, token for token the single-card engine
    of the same depth, served first. Returns the kernels' launches."""
    from polykey_tpu_torch.engine.config import EngineConfig
    from polykey_tpu_torch.engine.engine import KERNELS
    from polykey_tpu_torch.engine.replica_pool import ReplicaPool

    label = "replicas, two replicas each over its own one-rank mesh"
    t0 = time.monotonic()
    model, cut = _cut_depth(params, MESH_FEATURE_LAYERS)
    want = _one_at_a_time(EngineConfig(model=model), cut, seed, MESH_PROMPTS)
    with _one_rank_nccl("mesh"):
        t1 = time.monotonic()
        pool = ReplicaPool.create(EngineConfig(model=model, replicas=2),
                                  params=cut, device="cuda", seed=seed)
        try:
            up = time.monotonic() - t1
            engines = [rep.engine for rep in pool.replicas]
            check(all(e.mesh is not None and not e.is_follower for e in engines)
                  and engines[0].mesh is not engines[1].mesh
                  and engines[0].mesh.control is not engines[1].mesh.control,
                  f"{label}: the replicas do not each lead a mesh of their own")
            check(engines[0].params is engines[1].params
                  and engines[0].params["embed"].data_ptr() == params["embed"].data_ptr(),
                  f"{label}: the replicas do not share the serve phase's weights")
            for k in KERNELS.values():
                k.launches = 0
            ids = [_generate(engines[i % 2], [p])[0][0] for i, p in enumerate(MESH_PROMPTS)]
            counts = {name: k.launches for name, k in KERNELS.items()}
            captures = [e.stats()["graph_capture_s"] for e in engines]
        finally:
            pool.shutdown()
        del pool, engines
        gc.collect()
        torch.cuda.empty_cache()
    say("mesh", f"{label}, {MESH_FEATURE_LAYERS} layers: both up in {up:.1f} s (captures "
        f"{captures[0]:.2f} s and {captures[1]:.2f} s); kernel launches {counts}; "
        f"sub-phase {time.monotonic() - t0:.1f} s on {card}")
    _hold_mesh_ids(label, MESH_PROMPTS, ids, want, "the single-card engine's")
    check(all(counts[n] > 0 for n in ("flash_attention", "paged_attention_decode",
                                      "paged_write")),
          f"{label}: a kernel was not launched: {counts}")
    return counts


def _stream_ids(engine, prompt: str, max_new: int = 32) -> list:
    """One greedy request's token ids through `engine` (an engine or a pool)."""
    from polykey_tpu_torch.engine.engine import GenRequest

    request = GenRequest(prompt=prompt, max_new_tokens=max_new)
    engine.submit(request)
    toks = []
    while True:
        kind, value = request.out.get(timeout=600)
        check(kind != "error", f"engine error: {value}")
        if kind == "done":
            return toks
        toks.append(value)


def phase_mesh_disagg(seed: int, card: str, want: list) -> dict:
    """Phase 15a: a 1x1 Llama-3-8B pool whose workers are one-rank meshes
    (mesh_workers: each worker process brings a group of one up
    before its engine, which then takes the mesh path: its handoffs'
    pages gathered and scattered as whole pages); SPEC_GREEDY one at a
    time, token for token phase 15's pool (`want`). Returns each worker's
    kernel launches."""
    import shutil
    import signal
    import tempfile

    from polykey_tpu_torch.engine.config import EngineConfig
    from polykey_tpu_torch.engine.disagg_pool import DisaggPool

    label = "disagg, a 1x1 pool of one-rank mesh workers"
    state_dir = tempfile.mkdtemp(prefix="polykey-disagg-mesh-")
    config = EngineConfig(model="llama-3-8b", disagg="1x1", default_max_new_tokens=32,
                          disagg_heartbeat_s=0.25, disagg_recovery_wait_s=300.0,
                          request_timeout_s=600.0)
    saved = {k: os.environ.pop(k, None) for k in ("POLYKEY_FAULTS", "POLYKEY_DEVICE")}
    t0 = time.monotonic()
    pool, procs = None, []
    try:
        pool = DisaggPool.create(config, seed=seed, state_dir=state_dir, device="cuda",
                                 ready_timeout_s=400.0, mesh_workers=True)
        up = time.monotonic() - t0
        procs = [w.proc for w in pool.workers]
        ids = [_stream_ids(pool, p) for p in SPEC_GREEDY]
        stats = {w.tier: pool._worker_stats(w) for w in pool.workers}
    finally:
        if pool is not None:
            pool.shutdown()
        for proc in procs:
            if proc.poll() is None:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except OSError:
                    pass
                proc.wait(timeout=30)
        shutil.rmtree(state_dir, ignore_errors=True)
        for key, value in saved.items():
            if value is not None:
                os.environ[key] = value
    counts = {tier: st.get("kernel_launches", {}) for tier, st in stats.items()}
    say("mesh", f"{label}: pool up in {up:.1f} s; workers' meshes "
        f"{ {t: st.get('mesh') for t, st in stats.items()} }; handoffs imported "
        f"{stats['decode'].get('handoff_imports')}; kernel launches by worker {counts}; "
        f"sub-phase {time.monotonic() - t0:.1f} s on {card}")
    check(all(st.get("mesh", {}).get("world") == 1 and st["mesh"]["role"] == "leader"
              for st in stats.values()), f"{label}: a worker is not a one-rank mesh")
    _hold_mesh_ids(label, SPEC_GREEDY, ids, want, "phase 15's pool")
    check(stats["decode"].get("handoff_imports") == len(SPEC_GREEDY),
          f"{label}: handoffs {stats['decode'].get('handoff_imports')}")
    return counts


# -- phase 16a ---------------------------------------------------------------

# The Mixtral mesh sub-phase's prompts and tokens.
MIXTRAL_MESH_PROMPTS, MIXTRAL_MESH_TOKENS = MESH_PROMPTS[:3], 16


def phase_mesh_mixtral(seed: int, params, card: str) -> dict:
    """Phase 16a: Mixtral-8x7B's int8 weights (phase 16's tensors, their
    first MESH_FEATURE_LAYERS layers) behind the mesh engine over a
    one-rank NCCL group: the capacity-bucketed MoE through
    ops/moe.moe_mlp_sharded's whole-batch routing (a group of one gathers
    nothing); MIXTRAL_MESH_PROMPTS one at a time, token for token the
    single-card engine of the same depth, served first. Returns the
    kernels' launches."""
    from polykey_tpu_torch.engine.config import EngineConfig
    from polykey_tpu_torch.engine.engine import KERNELS

    label = "mixtral-8x7b, int8 weights, capacity-bucketed MoE"
    t0 = time.monotonic()
    model, cut = _cut_depth(params, MESH_FEATURE_LAYERS, "mixtral-8x7b")
    # The weights come quantized: the engines take them as they are.
    config = EngineConfig(model=model)
    want = _one_at_a_time(config, cut, seed, MIXTRAL_MESH_PROMPTS, MIXTRAL_MESH_TOKENS)
    with _one_rank_nccl("mesh"):
        engine, captured, up = _mesh_engine(config, cut, seed, label)
        check(engine.model_cfg.moe_dispatch, f"{label}: not the capacity-bucketed MoE")
        grpc = _Grpc(engine)
        try:
            for k in KERNELS.values():
                k.launches = 0
            ids = [grpc.generate([p], max_new=MIXTRAL_MESH_TOKENS, stream=True)[0][0]
                   for p in MIXTRAL_MESH_PROMPTS]
            counts = {name: k.launches for name, k in KERNELS.items()}
            st = engine.stats()
        finally:
            grpc.close()
        say("mesh", f"{label}, {MESH_FEATURE_LAYERS} layers: mesh engine up in {up:.1f} s "
            f"(graphs {st['graph_capture_s']:.2f} s, {captured['all_reduce']} all-reduces and "
            f"{captured['all_gather']} all-gathers captured); decode graph replays "
            f"{st['decode_graph_replays']}, prefill graph replays {st['prefill_graph_replays']}, "
            f"eager prefills {st['prefill_eager']}; kernel launches {counts}; sub-phase "
            f"{time.monotonic() - t0:.1f} s on {card}")
        _hold_mesh_ids(label, MIXTRAL_MESH_PROMPTS, ids, want, "the single-card engine's")
        check(st["prefill_eager"] == 0 and st["decode_graph_replays"] > 0,
              f"{label}: not every dispatch a replay: {st}")
        check(all(counts[n] > 0 for n in ("flash_attention", "paged_attention_decode",
                                          "paged_write")),
              f"{label}: a kernel was not launched: {counts}")
        del engine, grpc
        gc.collect()
        torch.cuda.empty_cache()
    return counts


# -- phase 11a ---------------------------------------------------------------

# The depth (of Llama-3-8B's or Mixtral-8x7B's 32 layers, at full width)
# the mesh sub-phases run at, to keep the script inside its time limit:
# phase 7a's bucketed sub-phases, phase 11a's ragged and spec sub-phases and
# phases 14a and 16a, each beside a single-card engine of the same depth.
MESH_FEATURE_LAYERS = 4


def _cut_depth(params, layers: int, model: str = "llama-3-8b") -> tuple:
    """(the name of a registered `model` config of `layers` layers, the
    weights' first `layers` layers: the same tensors, no copy)."""
    from polykey_tpu_torch.models.config import MODEL_REGISTRY, get_config

    cfg = replace(get_config(model), name=f"{model}-{layers}l", num_layers=layers)
    MODEL_REGISTRY[cfg.name] = cfg
    return cfg.name, dict(params, layers=params["layers"][:layers])


# Phase 18's engine geometry (analysis/graph.py GraphEnv's "full" profile
# with the card's page size and buckets wide enough for flash).
GRAPHLINT_CONFIG = dict(page_size=16, num_pages=160, max_seq_len=512,
                        prefill_buckets=(128, 256))
GRAPHLINT_KERNELS = ("flash_attention", "paged_attention_decode", "paged_write",
                     "ragged_paged_attention")


def phase_graphlint(seed: int, card: str) -> dict:
    """The port's graphlint on the card (module docstring, phase 18).
    Returns the sweeps' kernel launches ("launches")."""
    from pathlib import Path

    from polykey_tpu_torch.analysis import graph
    from polykey_tpu_torch.analysis.core import apply_baseline, load_baseline
    from polykey_tpu_torch.engine.engine import KERNELS

    from polykey_tpu_torch.engine.host_guard import HostSyncGuard, HostSyncTrip
    from polykey_tpu_torch.models.config import MODEL_REGISTRY, get_config
    from polykey_tpu_torch.models.transformer import init_params

    phase = "graphlint"
    t0 = time.monotonic()
    # The guard's teeth on the card: a host read trips it; the sync debug
    # mode it sets raises on a stream wait that no dispatch mode sees.
    teeth: list = []
    with contextlib.suppress(HostSyncTrip), HostSyncGuard(teeth, sync_debug=True):
        torch.ones(1, device="cuda").sum().item()
    check(len(teeth) == 1, f"the host-sync guard let .item() on the card pass: {teeth}")
    try:
        with HostSyncGuard(sync_debug=True):
            torch.cuda.current_stream().synchronize()
        sync_teeth = "did not raise"
    except RuntimeError as e:
        sync_teeth = f"raised ({str(e).splitlines()[0][:120]})"
    say(phase, f"guard teeth: .item() tripped it ({teeth[0]}); under sync debug mode "
        f"\"error\" a stream synchronize {sync_teeth}")
    check(sync_teeth.startswith("raised") and "synchroniz" in sync_teeth,
          f"the sync debug mode \"error\" is not in effect: a stream synchronize "
          f"{sync_teeth}")
    check(torch.cuda.get_sync_debug_mode() == 0,
          "the host-sync guard left the sync debug mode set")
    cfg = replace(get_config("llama-3-8b"), name=f"llama-3-8b-{MESH_FEATURE_LAYERS}l",
                  num_layers=MESH_FEATURE_LAYERS)
    MODEL_REGISTRY[cfg.name] = cfg
    params = init_params(cfg, torch.bfloat16, "cuda",
                         torch.Generator(device="cuda").manual_seed(seed))
    env = graph.GraphEnv(device="cuda", model=cfg.name, params=params, dtype="bfloat16",
                         overrides=GRAPHLINT_CONFIG)
    try:
        findings, env = graph.run_graph_checks(env)
        pools = {label: engine._graphs.pool_bytes for label, engine in env.engines()}
    finally:
        env.close()
    for line in env.logs:
        say(phase, line)
    baseline = load_baseline(Path(__file__).resolve().parent / graph.GRAPH_BASELINE)
    findings, _ = apply_baseline(findings, baseline)
    for f in findings:
        say(phase, ("BLOCKING " if f.blocking else "baselined ") + f.render())
    for label, pool in pools.items():
        census = dict(env.census.get(label, {}))
        crossings = census.pop("crossings", None)
        keys = ", ".join(f"{body} {c['keys']}" for body, c in sorted(census.items()))
        trips = sum(t.startswith(label + ":") for t in env.trips)
        start = sum(c["keys"] for c in census.values())
        after = sum(c["captures"] for c in census.values())
        check(start == after and start > 0,
              f"{label}: {start} graphs captured at start, {after} after the sweeps")
        say(phase, f"{label}: {start} graphs captured at start ({keys}), {after} after "
            f"the sweeps; replays in the sweeps "
            f"{sum(c['replays'] for c in census.values())}; graph pool "
            f"{pool / 2**20:.1f} MiB; crossing census {crossings}; guard trips {trips}")
    launches = {k: env.sweep_launches[k] for k in KERNELS}
    say(phase, f"kernel launches in the sweeps {launches}")
    say(phase, f"wall {time.monotonic() - t0:.1f} s (5 engines of {MESH_FEATURE_LAYERS} "
        f"layers: captures, three guarded or watched sweeps each at depths 1 and 2, "
        f"one dispatch of each step, the abstract contracts) on {card}")
    blocking = [f for f in findings if f.blocking]
    check(not blocking, f"graphlint: {len(blocking)} blocking finding(s)")
    check(not env.trips, f"graphlint: guard trips {env.trips}")
    check(all(launches[k] > 0 for k in GRAPHLINT_KERNELS),
          f"graphlint: a kernel of the sweeps launched 0 times: {launches}")
    return {"launches": launches}


def _one_at_a_time(config, params, seed: int, prompts: list, max_new: int = 32) -> list:
    """The single-card engine of `config` on `params`: `prompts` one at a
    time over streamed gRPC, greedy, `max_new` tokens each (its token ids)."""
    from polykey_tpu_torch.engine.engine import InferenceEngine

    grpc = _Grpc(InferenceEngine(config, params=params, device="cuda", seed=seed))
    try:
        check(grpc.engine.mesh is None, "a reference engine took the mesh path")
        return [grpc.generate([p], max_new=max_new, stream=True)[0][0] for p in prompts]
    finally:
        grpc.close()
        grpc.engine.release_device_state()


def phase_mesh_features(seed: int, params, card: str) -> dict:
    """The engine's own features on the mesh engine over a one-rank NCCL
    group (module docstring, phase 11a). Every sub-phase runs at
    MESH_FEATURE_LAYERS layers, each against the single-card engine of the
    same config and depth, served first (before the group is up): the
    prefix sub-phase's is the host-tier engine of `_prefix_reference`.
    Returns the kernels' launches by sub-phase."""
    from polykey_tpu_torch.engine.config import EngineConfig

    phase = "mesh"
    launches = {}
    t0 = time.monotonic()
    model, cut = _cut_depth(params, MESH_FEATURE_LAYERS)
    subs = [(f"ragged, {'int8 KV' if int8 else 'bf16 KV'}",
             EngineConfig(model=model, ragged_dispatch=True, kv_dtype="int8" if int8 else ""),
             MESH_PROMPTS) for int8 in (False, True)]
    subs += [(f"spec {key}", EngineConfig(model=model, spec_gamma=4, **fields), SPEC_GREEDY)
             for key, fields in MESH_SPEC.items()]
    want = {label: _one_at_a_time(config, cut, seed, prompts)
            for label, config, prompts in subs}
    prefix_ref = _prefix_reference(seed, model, cut)
    say(phase, f"references at {MESH_FEATURE_LAYERS} layers: {time.monotonic() - t0:.1f} s")
    with _one_rank_nccl(phase):
        for label, config, _ in subs:
            if config.draft_model is None:
                launches[label] = _mesh_ragged(seed, cut, card, config, want[label])
            else:
                launches[label] = _mesh_spec(seed, cut, card, config, label[5:], want[label])
        prefix = _mesh_prefix(seed, card, prefix_ref)
        launches["prefix"] = prefix["prefix"]
        for kind, restart in prefix["restart"].items():
            if kind != "memory_gib":
                launches[f"restart {kind}"] = restart["launches"]
    say(phase, f"ragged, spec and prefix sub-phases: {time.monotonic() - t0:.1f} s")
    return {"launches": launches}


def _mesh_ragged(seed: int, params, card: str, config, want: list) -> dict:
    """The ragged dispatch on the mesh engine: MESH_PROMPTS one at a time
    over gRPC, held to the ragged serve phase's streams; the ragged kernel
    of the KV type launches, flash does not."""
    from polykey_tpu_torch.engine.engine import KERNELS

    int8 = config.kv_dtype == "int8"
    label = f"ragged, {'int8 KV' if int8 else 'bf16 KV'}"
    t0 = time.monotonic()
    engine, captured, up = _mesh_engine(config, params, seed, label)
    grpc = _Grpc(engine)
    try:
        for k in KERNELS.values():
            k.launches = 0
        ids = [grpc.generate([p], stream=True)[0][0] for p in MESH_PROMPTS]
        counts = {name: k.launches for name, k in KERNELS.items()}
        st = engine.stats()
    finally:
        grpc.close()
    rag = "ragged_paged_attention_int8" if int8 else "ragged_paged_attention"
    say("mesh", f"{label}: mesh engine up in {up:.1f} s (graphs {st['graph_capture_s']:.2f} s, "
        f"{captured['all_reduce']} all-reduces and {captured['all_gather']} all-gathers "
        f"captured), stream width {st['ragged_width']}; {st['ragged_dispatches']} ragged "
        f"dispatches; kernel launches {counts}; sub-phase {time.monotonic() - t0:.1f} s "
        f"on {card}")
    _hold_mesh_ids(label, MESH_PROMPTS, ids, want, "the single-card engine's")
    check(counts[rag] > 0 and st["ragged_dispatches"] > 0,
          f"{label}: the ragged kernel did not launch on the mesh engine: {counts}")
    check(counts["flash_attention"] == 0, f"{label}: flash launched in ragged mode")
    del engine, grpc
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _mesh_spec(seed: int, params, card: str, config, key: str, want: list) -> dict:
    """A 1B draft on the mesh engine (its weights drawn from seed + 2 as on
    one card): SPEC_GREEDY one at a time over gRPC, held to phase_spec's
    sub-phase `key`; the spec graphs capture their collectives and every
    round is a replay."""
    from polykey_tpu_torch.engine.engine import KERNELS

    ragged = config.ragged_dispatch
    label = f"spec {key}, 1B draft, {'ragged, ' if ragged else ''}{config.kv_dtype or 'bf16'} KV"
    t0 = time.monotonic()
    engine, captured, up = _mesh_engine(config, params, seed, label)
    grpc = _Grpc(engine)
    try:
        for k in KERNELS.values():
            k.launches = 0
        ids = [grpc.generate([p], stream=True)[0][0] for p in SPEC_GREEDY]
        counts = {name: k.launches for name, k in KERNELS.items()}
        st = engine.stats()
    finally:
        grpc.close()
    say("mesh", f"{label}: mesh engine up in {up:.1f} s; graphs captured in "
        f"{st['graph_capture_s']:.2f} s ({st['decode_graph_captures']} decode, "
        f"{st['prefill_graph_captures']} prefill, {st['spec_graph_captures']} spec), "
        f"{captured['all_reduce']} all-reduces and {captured['all_gather']} all-gathers "
        f"issued inside them; spec graph replays {st['spec_graph_replays']}, eager rounds "
        f"{st['spec_eager']}, eager prefills {st['prefill_eager']}"
        + (f", ragged spec dispatches {st['ragged_spec_dispatches']}" if ragged else "")
        + f"; acceptance {st.get('spec_acceptance', 0.0)}; kernel launches {counts}; "
        f"sub-phase {time.monotonic() - t0:.1f} s on {card}")
    cfg, tokenizer = engine.model_cfg, engine.tokenizer

    def margin(prompt, i, g, w):
        m = _near_tie(params, cfg, tokenizer.encode(prompt), w[:i], g[i], w[i])
        return (f"{g[i]} against {w[i]}, both within {m:.4f} of the top logit on the "
                f"plain path")

    _hold_mesh_ids(label, SPEC_GREEDY, ids, want, "the single-card engine's", margin)
    check(st["spec_graph_captures"] > 0 and st["spec_graph_replays"] > 0
          and st["spec_eager"] == 0, f"{label}: rounds not all graph replays: {st}")
    check(captured["all_reduce"] > 0 and captured["all_gather"] > 0,
          f"{label}: no collective was captured: {captured}")
    int8 = config.kv_dtype == "int8"
    dec = "paged_attention_decode_int8" if int8 else "paged_attention_decode"
    check(counts[dec] > 0, f"{label}: the decode kernel did not launch: {counts}")
    if ragged:
        rag = "ragged_paged_attention_int8" if int8 else "ragged_paged_attention"
        check(counts[rag] > 0 and st["ragged_spec_dispatches"] > 0,
              f"{label}: no ragged spec dispatch launched the ragged kernel: {counts}")
    else:
        check(st["prefill_eager"] == 0, f"{label}: a prefill ran eagerly")
    del engine, grpc
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _prefix_groups() -> list:
    """The prefix sub-phase's requests in their groups, each sent from an
    idle card: phase 10's header's miss, 4 hits at once, 4 more, one
    alone, the second header (which spills the first) and the first again
    (restored)."""
    miss = PREFIX_HEADER + PREFIX_TAILS[0]
    return [[miss], [PREFIX_HEADER + t for t in PREFIX_TAILS[1:5]],
            [PREFIX_HEADER + t for t in PREFIX_TAILS[5:9]], [PREFIX_HEADER + PREFIX_TAILS[9]],
            [PREFIX_OTHER + PREFIX_TAILS[0]], [miss]]


def _prefix_reference(seed: int, model: str, params) -> dict:
    """The single-card engine with phase 10's host tier, of `model` on
    `params`, serving `_prefix_groups()`: their ids, the pages matched,
    spilled and restored, and the state dir its spills wrote (removed by
    `_mesh_prefix`)."""
    import tempfile

    from polykey_tpu_torch.engine.config import EngineConfig
    from polykey_tpu_torch.engine.engine import InferenceEngine

    state_dir = tempfile.mkdtemp(prefix="polykey-prefix-state-", dir=tempfile.gettempdir())
    config = EngineConfig(model=model, prefix_cache=True, kv_state_dir=state_dir,
                          **PREFIX_HOST_TIER)
    engine = InferenceEngine(config, params=params, device="cuda", seed=seed)
    try:
        check(engine.mesh is None, "the prefix reference took the mesh path")
        got = []
        for group in _prefix_groups():
            _drain(engine)
            got += _generate(engine, group)
        end = engine.stats()
    finally:
        engine.shutdown()
        engine.release_device_state()
    return {"ids": [r[0] for r in got], "counts": {k: end[k] for k in PREFIX_COUNTS},
            "state_dir": state_dir, "model": model, "params": params}


def _mesh_prefix(seed: int, card: str, ref: dict) -> dict:
    """The prefix cache and the host tier on the mesh engine: phase_prefix's
    host-tier engine's requests in its groups (the header's miss, 4 hits,
    4 more, one alone, the second header that spills the first, the first
    again, restored), their ids and the pages matched, spilled and
    restored held to the single-card engine's; the lone hit's TTFT not
    above the miss's. Its spills go to a state dir, whose files (whole
    pages, lockstep.gather_pages) must be the single-card engine's byte
    for byte. Then the in-process restarts (`_mesh_restart`): behind
    TorchService.create's supervisor, a fault injected into the engine
    loop (before any record of its dispatch goes out) kills the engine;
    the supervisor rebuilds it on the mesh's next life and the same
    weights, the fresh engine reloads the state dir (lockstep.scatter_pages)
    and serves the header's miss again from the host tier, token for token
    the single-card engine's; then (a) a failure inside a prefill's
    dispatch and (b) a wedge restart it twice more."""
    import shutil
    import tempfile

    from polykey_tpu_torch.engine.config import EngineConfig
    from polykey_tpu_torch.engine.engine import KERNELS

    label = "prefix, bucketed bf16 with the host tier"
    state_dir = tempfile.mkdtemp(prefix="polykey-mesh-state-", dir=tempfile.gettempdir())
    config = EngineConfig(model=ref["model"], prefix_cache=True, kv_state_dir=state_dir,
                          watchdog_timeout_s=MESH_WATCHDOG_S, **PREFIX_HOST_TIER)
    params = ref["params"]
    t0 = time.monotonic()
    engine, _, up = _mesh_engine(config, params, seed, label)
    groups = _prefix_groups()
    miss = groups[0][0]
    try:
        for k in KERNELS.values():
            k.launches = 0
        got = []
        for group in groups:
            _drain(engine)
            got += _generate(engine, group)
        counts = {name: k.launches for name, k in KERNELS.items()}
        end = engine.stats()
        pages = {k: end[k] for k in PREFIX_COUNTS}
        say("mesh", f"{label}: mesh engine up in {up:.1f} s; {len(got)} requests; pages "
            f"{pages} (the single-card engine's {ref['counts']}); TTFT miss {got[0][1]:.1f} ms, "
            f"lone hit {got[9][1]:.1f} ms, the first header again after its spill "
            f"{got[-1][1]:.1f} ms; kernel launches {counts}; sub-phase "
            f"{time.monotonic() - t0:.1f} s on {card}")
        _hold_mesh_ids(label, [p for g in groups for p in g], [r[0] for r in got], ref["ids"],
                       "the prefix phase's host-tier engine's")
        check(pages == ref["counts"], f"{label}: pages {pages}, not the single-card "
              f"engine's {ref['counts']}")
        check(pages["kv_pages_evicted"] > 0 and pages["kv_pages_restored"] > 0,
              f"{label}: no spill and restore: {pages}")
        check(got[9][1] <= got[0][1], f"{label}: the lone hit ({got[9][1]:.1f} ms) is slower "
              f"than the miss ({got[0][1]:.1f} ms)")
        # Compared once the engine has died: the last retirement's spill
        # may still run after its request is done.
        restart = _mesh_restart(engine, miss, ref["ids"][0], card, lambda: _same_state_dirs(
            label, state_dir, ref["state_dir"], card))
    finally:
        engine.shutdown()
        shutil.rmtree(state_dir, ignore_errors=True)
        shutil.rmtree(ref["state_dir"], ignore_errors=True)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return {"prefix": counts, "restart": restart}


def _state_batches(directory: str) -> dict:
    """{seq: (blob bytes, sidecar dict)} of a state dir one engine wrote."""
    out = {}
    for name in os.listdir(directory):
        if name.endswith(".pkkv"):
            stem = name[:-len(".pkkv")]
            with open(os.path.join(directory, name), "rb") as f:
                blob = f.read()
            with open(os.path.join(directory, stem + ".keys.json")) as f:
                out[int(stem.split("-")[1])] = (blob, json.load(f))
    return out


def _same_state_dirs(label: str, mesh_dir: str, single_dir: str, card: str) -> None:
    """The mesh engine's state dir byte for byte the single-card engine's:
    the same batches in the same order, each blob and sidecar equal."""
    got, want = _state_batches(mesh_dir), _state_batches(single_dir)
    nbytes = sum(len(b) for b, _ in got.values())
    say("mesh", f"{label}: state dir of {len(got)} spill batches ({nbytes} blob bytes, "
        f"{sum(len(s['keys']) for _, s in got.values())} pages) against the single-card "
        f"engine's {len(want)}: "
        f"{sum(got.get(q) == want[q] for q in want)} byte-identical, on {card}")
    check(want and sorted(got) == sorted(want), f"{label}: spill batches {sorted(got)} "
          f"against the single-card engine's {sorted(want)}")
    for seq in sorted(want):
        check(got[seq][1] == want[seq][1], f"{label}: batch {seq}'s sidecar differs")
        check(got[seq][0] == want[seq][0], f"{label}: batch {seq}'s blob differs")


MESH_WATCHDOG_S = 3.0   # the mesh restarts' watchdog window
MESH_JOIN_S = 1.0       # their supervisor's join window
MESH_STALL_S = 7.0      # restart (b)'s step-stall: past the window and the join


def _mesh_restart(engine, prompt: str, want: list, card: str, restarted) -> dict:
    """The mesh engine behind TorchService.create's supervisor (watchdog
    window MESH_WATCHDOG_S, join window MESH_JOIN_S), restarted in process
    three times, each into the mesh's next life (lockstep.restart: the old
    life's NCCL communicators aborted, new groups made, the fresh engine's
    captures warming them): after an injected failure of its engine loop
    before any record of its dispatch goes out (`restarted()` runs once
    that fresh engine is up, before it serves); (a) after the prefill-error
    point fires inside a prefill's dispatch; (b) after a step-stall of
    MESH_STALL_S wedges the engine thread past the watchdog window and the
    join, so the supervisor keeps it as an orphan, reaped once it wakes.
    After each, `prompt` is served and held to `want`. Returns the kernel
    launches serving `prompt` after each restart and the seconds from each
    failure to the fresh engine serving, with its capture seconds."""
    from polykey_tpu_torch import faults
    from polykey_tpu_torch.engine.engine import KERNELS, GenRequest
    from polykey_tpu_torch.gateway.health import SERVING, HealthService
    from polykey_tpu_torch.gateway.torch_service import TorchService
    from polykey_tpu_torch.obs import Observability

    label = "restart, the prefix sub-phase's mesh engine"
    health, obs = HealthService(), Observability()
    health.set_serving_status("", SERVING)
    engine.health = health
    service = TorchService.create(engine, health=health, obs=obs)
    supervisor = service.supervisor
    supervisor.check_interval_s = service.watchdog.check_interval_s = 0.1
    supervisor.join_timeout_s = MESH_JOIN_S
    sync()
    def held() -> tuple:            # (allocated, reserved) bytes
        return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()

    memory = {"before the faults": held()}
    # Read as the supervisor swaps the fresh engine in, before it can reap
    # an orphan (the next tick of its thread).
    at_restart: list = []
    supervisor.add_restart_listener(lambda _: at_restart.append(held()))
    out = {}
    try:
        check(engine.mesh_restart, f"{label}: the service did not arm the mesh restart")

        def fail(old, arm, expect: str, kind: str):
            """Fail `old` with `arm`, wait for the supervisor's restart and
            serve `prompt` on the fresh engine; returns it."""
            restarts = supervisor.restarts
            arm(old)
            t0 = time.monotonic()
            request = GenRequest(prompt=prompt, max_new_tokens=4)
            old.submit(request)
            while (item := request.out.get(timeout=300))[0] == "token":
                pass
            check(item[0] == "error" and expect in str(item[1]),
                  f"{label} ({kind}): the failed request ended {item}")
            while supervisor.restarts == restarts and not supervisor.gave_up \
                    and time.monotonic() - t0 < 300:
                time.sleep(0.01)
            up = time.monotonic() - t0
            fresh = service.engine
            check(supervisor.restarts == restarts + 1 and fresh is not old,
                  f"{label} ({kind}): no restart (gave up: {supervisor.gave_up})")
            check(old.closed_with == "rebuild" and fresh.mesh.life == old.mesh.life + 1
                  and np.array_equal(fresh.mesh.devices, old.mesh.devices)
                  and fresh.params is old.params,
                  f"{label} ({kind}): closed with {old.closed_with!r}, life "
                  f"{old.mesh.life} -> {fresh.mesh.life}")
            check(health._statuses[""] == SERVING, f"{label} ({kind}): health not SERVING")
            memory[f"at restart {kind}"] = at_restart[-1]
            st = fresh.stats()
            if restarts == 0:
                restarted()
            for k in KERNELS.values():
                k.launches = 0
            got = _generate(fresh, [prompt])
            counts = {name: k.launches for name, k in KERNELS.items()}
            _hold_mesh_ids(f"{label} ({kind})", [prompt], [got[0][0]], [want],
                           "the single-card engine's")
            check(all(counts[n] > 0 for n in ("flash_attention", "paged_attention_decode",
                                              "paged_write")),
                  f"{label} ({kind}): a kernel was not launched: {counts}")
            groups = {g.group_name[:8] for g in fresh.mesh.groups.values()}
            say("mesh", f"{label} ({kind}): the failure to the fresh engine serving in "
                f"{up:.2f} s (its capture {st['graph_capture_s']:.2f} s), life "
                f"{fresh.mesh.life} on groups {sorted(groups)}, health SERVING, restarts "
                f"{supervisor.restarts}; {st['kv_reloaded_pages']} pages reloaded from the "
                f"state dir; the header's miss again: TTFT {got[0][1]:.1f} ms, its ids the "
                f"single-card engine's; kernel launches {counts}; "
                f"{memory[f'at restart {kind}'][0] / 2**30:.3f} GiB allocated at the restart "
                f"on {card}")
            out[kind] = {"launches": counts, "restart_s": up,
                         "capture_s": st["graph_capture_s"]}
            return fresh

        def crash(old):
            def failing():
                raise RuntimeError("injected engine-loop failure")

            old._dispatch_step = failing

        fresh = fail(engine, crash, "injected", "outside a dispatch")
        st = fresh.stats()
        check(st["kv_reloaded_pages"] > 0 and st["prefix_host_hit_tokens"] > 0,
              f"{label}: the state dir did not warm the fresh engine: {st}")
        # (a) A failure inside a dispatch: the prefill's record sent.
        old = fresh
        fresh = fail(old, lambda e: setattr(e, "_faults", faults.install("prefill-error@1")),
                     "injected fault: prefill-error", "(a) inside a dispatch")
        _aborted(old, label, card)
        # (b) A wedge: the thread sleeps past the watchdog and the join.
        old = fresh
        fresh = fail(old, lambda e: setattr(e, "_faults", faults.install(
            f"step-stall={MESH_STALL_S}@1")), "engine", "(b) a wedge")
        restart = [e for e in obs.recorder.events() if e["kind"] == "engine_restart"][-1]
        check(restart["wedged"], f"{label} (b): the wedged engine was not orphaned")
        t0 = time.monotonic()
        while supervisor.orphans and time.monotonic() - t0 < 60:
            time.sleep(0.05)
        check(not supervisor.orphans and old.paged is None and not old._thread.is_alive()
              and old.dead is not None,
              f"{label} (b): the orphan was not reaped within 60 s")
        sync()
        memory["after the reap"] = held()
        _aborted(old, label, card)
        kinds = [e["kind"] for e in obs.recorder.events()]
        counter = service.restart_counter.value()
        check("watchdog_stall" in kinds and kinds.count("engine_restart") == 3
              and "engine_released" in kinds and counter == 3,
              f"{label}: flight recorder {kinds}, polykey_engine_restarts_total {counter}")
        say("mesh", f"{label} (b): the orphan woke {MESH_STALL_S} s into its stall into a "
            f"dead engine, dispatched nothing, ended and was reaped (the reap seen "
            f"{time.monotonic() - t0:.2f} s after the fresh engine served); the process lives on "
            f"(TORCH_NCCL_ASYNC_ERROR_HANDLING="
            f"{os.environ.get('TORCH_NCCL_ASYNC_ERROR_HANDLING', 'unset')}); flight "
            f"recorder {kinds}, polykey_engine_restarts_total {counter:g}; memory "
            f"allocated / reserved (GiB) " + ", ".join(
                f"{k} {a / 2**30:.3f} / {r / 2**30:.3f}" for k, (a, r) in memory.items())
            + f" on {card}")
        _generate(fresh, [prompt])
    finally:
        faults.clear()
        service.close()
    out["memory_gib"] = {k: (a / 2**30, r / 2**30) for k, (a, r) in memory.items()}
    return out


def _aborted(old, label: str, card: str) -> None:
    """A collective on `old`'s life's tp group, aborted at the restart,
    raises at once (in a thread, joined within 30 s)."""
    import torch.distributed as dist

    group, box = old.mesh.group("tp"), {}

    def probe():
        t0 = time.monotonic()
        try:
            dist.all_reduce(torch.ones(1, device="cuda"), group=group)
            torch.cuda.synchronize()
            box["got"] = "returned"
        except Exception as e:
            box["got"] = f"{type(e).__name__}: {str(e)[:80]}"
        box["s"] = time.monotonic() - t0

    thread = threading.Thread(target=probe, daemon=True)
    thread.start()
    thread.join(30)
    check(not thread.is_alive() and box.get("got", "returned") != "returned",
          f"{label}: a collective on life {old.mesh.life}'s aborted group {box or 'hung'}")
    say("mesh", f"{label}: life {old.mesh.life}'s communicator aborted: a collective on it "
        f"raised in {box['s'] * 1e3:.1f} ms ({box['got']}) on {card}")


# -- phase 8 ---------------------------------------------------------------

def phase_graph(seed: int, params, card: str, turns: int = 3) -> None:
    """The full-depth decode block eager and as its graph's replay, from the
    same lanes: identical tokens and lane state, then walls and idle shares
    in turns."""
    from polykey_tpu_torch.engine.config import EngineConfig
    from polykey_tpu_torch.models.config import get_config
    from polykey_tpu_torch.tools.profile_decode import (
        LANES,
        decode_block,
        decode_lanes,
        device_kernels,
    )

    econf = EngineConfig(model="llama-3-8b")
    cfg = get_config(econf.model)
    steps, context = econf.decode_block_steps, 512
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for int8 in (False, True):
        kv = "int8 KV" if int8 else "bf16 KV"
        gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        paged, state = decode_lanes(econf, cfg, context, gen, int8)
        with torch.inference_mode():
            eager, reset = decode_block(params, cfg, paged, state, steps)
            graph, _ = decode_block(params, cfg, paged, state, steps, graph=True)
            out = {}
            for name, run in (("eager", eager), ("graph", graph)):
                reset()
                packed = run().clone()
                out[name] = (packed, {k: state[k].clone() for k in LANES})
            sync()
            check(torch.equal(out["graph"][0], out["eager"][0]),
                  f"{kv}: the graph's packed tokens differ from the eager block's")
            check(all(torch.equal(out["graph"][1][k], out["eager"][1][k]) for k in LANES),
                  f"{kv}: the graph's lane state differs from the eager block's")
            tokens = out["eager"][0]
            check(bool((tokens >= 0).all()), f"{kv}: a live lane emitted nothing")
            walls, idle = {"eager": [], "graph": []}, {"eager": [], "graph": []}
            for turn in range(2 * turns):
                name = ("eager", "graph", "graph", "eager")[turn % 4]
                run = eager if name == "eager" else graph
                reset()
                sync()
                t0 = time.perf_counter()
                run()
                sync()
                wall = (time.perf_counter() - t0) * 1e3
                reset()
                sync()
                with torch.profiler.profile(activities=acts) as prof:
                    run()
                    sync()
                busy = sum(e.time_range.elapsed_us() for e in device_kernels(prof)) / 1e3
                walls[name].append(wall / steps)
                idle[name].append(1 - busy / wall if busy else float("nan"))
        del paged, state
        say("graph", f"llama-3-8b 32 layers bf16, {kv}, 16 greedy lanes at context "
            f"{context}, block of {steps}: graph replay and eager block identical "
            f"(packed [{steps}, 16] tokens {tokens[0, :4].tolist()}..., lane state)")
        for name in ("eager", "graph"):
            w, i = walls[name], idle[name]
            say("graph", f"{kv}, {name}: wall per step median {statistics.median(w):.3f} "
                f"ms (range {min(w):.3f}-{max(w):.3f}), idle share median "
                f"{statistics.median(i):.3f} (range {min(i):.3f}-{max(i):.3f}), "
                f"{len(w)} runs, on {card}")


# -- phase 9 ---------------------------------------------------------------

def phase_prefill_graph(seed: int, params, card: str, turns: int = 3) -> None:
    """The full-depth bucketed prefill (width 512 at positions 1024..1535,
    group pads 1 and 8, greedy) eager and as its graph's replay from the
    same pools: identical tokens and KV pages, then walls and idle shares
    in turns."""
    from polykey_tpu_torch.engine.config import EngineConfig
    from polykey_tpu_torch.engine.kv_cache import init_paged_kv
    from polykey_tpu_torch.models.config import get_config
    from polykey_tpu_torch.tools.profile_decode import (
        device_kernels,
        prefill_block,
        prefill_inputs,
    )

    econf = EngineConfig(model="llama-3-8b")
    cfg = get_config(econf.model)
    T, context = max(econf.prefill_buckets), 1024
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for int8 in (False, True):
        kv = "int8 KV" if int8 else "bf16 KV"
        gen = torch.Generator(device="cuda").manual_seed(seed + 2)
        paged = init_paged_kv(cfg, econf.num_pages, econf.page_size, torch.bfloat16,
                              "cuda", kv_dtype=torch.int8 if int8 else None)
        pools = [t for t in (paged.k, paged.v, paged.ks, paged.vs) if t is not None]
        for n in (1, 8):
            ops = prefill_inputs(econf, cfg, T, context, n, gen)
            tables = ops.views(T)[3]
            pages = torch.unique(tables[tables > 0]).long()
            with torch.inference_mode():
                eager = prefill_block(params, cfg, paged, ops, T)
                graph = prefill_block(params, cfg, paged, ops, T, graph=True)
                # Random KV on the rows' pages: the context is read, the
                # chunk written.
                for t in pools:
                    shape = (t.shape[0], len(pages), *t.shape[2:])
                    if t.dtype == torch.int8:
                        fill = torch.randint(-127, 128, shape, generator=gen,
                                             device="cuda", dtype=torch.int8)
                    elif int8:
                        fill = (torch.rand(shape, generator=gen, device="cuda") * 0.02
                                + 1e-3).to(torch.bfloat16)
                    else:
                        fill = torch.randn(shape, generator=gen, device="cuda",
                                           dtype=torch.bfloat16)
                    t[:, pages] = fill
                    del fill
                saved = [t[:, pages].clone() for t in pools]
                out = {}
                for name, run in (("eager", eager), ("graph", graph)):
                    for t, v in zip(pools, saved):
                        t[:, pages] = v
                    tokens = run().clone()
                    out[name] = (tokens, [t[:, pages].clone() for t in pools])
                sync()
                check(torch.equal(out["graph"][0], out["eager"][0]),
                      f"{kv}, {n} rows: the graph's tokens differ from the eager prefill's")
                check(all(torch.equal(a, b) for a, b in zip(out["graph"][1], out["eager"][1])),
                      f"{kv}, {n} rows: the graph's KV pages differ from the eager prefill's")
                check(not all(torch.equal(a, b) for a, b in zip(saved, out["eager"][1])),
                      f"{kv}, {n} rows: the prefill wrote no KV")
                tokens = out["eager"][0].tolist()
                del saved, out
                walls, idle = {"eager": [], "graph": []}, {"eager": [], "graph": []}
                for turn in range(2 * turns):
                    name = ("eager", "graph", "graph", "eager")[turn % 4]
                    run = eager if name == "eager" else graph
                    sync()
                    t0 = time.perf_counter()
                    run()
                    sync()
                    wall = (time.perf_counter() - t0) * 1e3
                    with torch.profiler.profile(activities=acts) as prof:
                        run()
                        sync()
                    busy = sum(e.time_range.elapsed_us() for e in device_kernels(prof)) / 1e3
                    walls[name].append(wall)
                    idle[name].append(1 - busy / wall if busy else float("nan"))
            del graph, eager, ops
            torch.cuda.empty_cache()
            say("prefill-graph", f"llama-3-8b 32 layers bf16, {kv}, {n} x {T} tokens at "
                f"positions {context}..{context + T - 1}, greedy: graph replay and eager "
                f"prefill identical (tokens {tokens}, the KV pages of {len(pages)} pages)")
            for name in ("eager", "graph"):
                w, i = walls[name], idle[name]
                say("prefill-graph", f"{kv}, {n} rows, {name}: walls "
                    f"{', '.join(f'{x:.3f}' for x in w)} ms, idle shares "
                    f"{', '.join(f'{x:.3f}' for x in i)}; median wall "
                    f"{statistics.median(w):.3f} ms, idle {statistics.median(i):.3f}, "
                    f"on {card}")
        del paged, pools
        torch.cuda.empty_cache()


# -- phase 10 ---------------------------------------------------------------

# A 1024-token header with the byte tokenizer's BOS (64 pages of 16) and
# ~100-token tails: the shared-system-prompt traffic of tool-calling callers.
PREFIX_HEADER = ("You are the tool-calling assistant of a ticketing service. Answer "
                 "with one JSON object naming the tool and its arguments. ") * 8
PREFIX_HEADER = (PREFIX_HEADER * 2)[:1023]
PREFIX_OTHER = ("You are the support assistant of a billing service. Quote the "
                "invoice line you rely on, then answer in one short paragraph. ") * 20
PREFIX_OTHER = PREFIX_OTHER[:1023]
PREFIX_TAILS = [
    f"Request {i}: the customer of order {1000 + 37 * i} asks whether it shipped and "
    f"when it arrives. Reply with the tool call."
    for i in range(10)
]


def _generate(engine, prompts: list, max_new: int = 32) -> list:
    """Submit `prompts` together to the engine; returns (token ids, TTFT ms,
    ms from submit to admission) for each, after all finished."""
    from polykey_tpu_torch.engine.engine import GenRequest

    reqs = [GenRequest(prompt=p, max_new_tokens=max_new) for p in prompts]
    for r in reqs:
        engine.submit(r)
    out = []
    for r in reqs:
        toks = []
        while True:
            kind, value = r.out.get(timeout=600)
            check(kind != "error", f"engine error: {value}")
            if kind == "done":
                break
            toks.append(value)
        check(len(toks) == max_new, f"{len(toks)} tokens, not {max_new}")
        t = r.timings
        out.append((toks, t.ttft_ms, (t.prefill_start - t.enqueued) * 1e3))
    return out


def _drain(engine) -> None:
    """Wait until the engine has nothing queued or in flight and the card
    has run everything enqueued: each measured step starts on an idle card
    (a finished stream's last blocks may still be queued on it)."""
    deadline = time.monotonic() + 60
    while (engine.busy or engine._inflight_q) and time.monotonic() < deadline:
        time.sleep(0.005)
    check(not engine.busy, "the engine did not go idle")
    sync()


def phase_prefix(seed: int, params, card: str) -> dict:
    """The prefix cache and the host tier at full width (module docstring,
    phase 10). Returns the kernel launches made in it ("launches")."""
    from polykey_tpu_torch.engine.config import EngineConfig
    from polykey_tpu_torch.engine.engine import KERNELS, InferenceEngine
    from polykey_tpu_torch.engine.kv_cache import host_kv_page_bytes
    from polykey_tpu_torch.models.config import get_config

    for k in KERNELS.values():
        k.launches = 0
    model = "llama-3-8b"
    cfg = get_config(model)
    ps = EngineConfig().page_size
    page_bytes = host_kv_page_bytes(cfg, ps, torch.bfloat16)
    miss = PREFIX_HEADER + PREFIX_TAILS[0]
    # Four hits at once, four more at once, then one alone, each group
    # from an idle card.
    hits = [PREFIX_HEADER + t for t in PREFIX_TAILS[1:5]]
    more = [PREFIX_HEADER + t for t in PREFIX_TAILS[5:9]]
    lone = [PREFIX_HEADER + PREFIX_TAILS[9]]
    # The bucketed bf16 engine holds the host tier too: 160 pages (73 a
    # request) leave no room for a second header beside the first's cached
    # pages, and 1 GiB of host memory holds 512 of them.
    modes = [
        ("bucketed bf16", dict(), dict(PREFIX_HOST_TIER)),
        ("bucketed int8", dict(kv_dtype="int8"), dict()),
        ("ragged bf16", dict(ragged_dispatch=True), dict()),
    ]
    for label, mode, extra in modes:
        base = EngineConfig(model=model, **mode)
        cold = InferenceEngine(base, params=params, device="cuda", seed=seed)
        try:
            want = []
            for group in ([miss], hits, more, lone, [PREFIX_OTHER + PREFIX_TAILS[0]]):
                _drain(cold)
                want += _generate(cold, group)
            cold_other = want.pop()
        finally:
            cold.shutdown()
        del cold
        engine = InferenceEngine(replace(base, prefix_cache=True, **extra), params=params,
                                 device="cuda", seed=seed)
        try:
            ids = [engine.tokenizer.encode(p) for p in [miss] + hits + more + lone]
            before = engine.stats()
            got = _generate(engine, [miss])
            after_miss = engine.stats()
            _drain(engine)
            cached = [engine._prefix.probe_tiered(np.asarray(i, np.int32))[0] // ps
                      for i in ids[1:]]
            blocks = []
            for group in (hits, more, lone):
                _drain(engine)
                b0 = engine.stats()["blocks_dispatched"]
                got += _generate(engine, group)
                blocks.append(engine.stats()["blocks_dispatched"] - b0)
            stats = engine.stats()
            for n, ((toks, *_), (ref, *_)) in enumerate(zip(got, want)):
                diff = next((i for i, (a, b) in enumerate(zip(toks, ref)) if a != b), None)
                check(diff is None, f"prefix {label}: request {n}'s text differs from "
                      f"the uncached engine's from token {diff} on")
            matched = stats["prefix_hit_tokens"] - before["prefix_hit_tokens"]
            check(matched == sum(cached) * ps and min(cached) >= 64,
                  f"prefix {label}: {matched} tokens matched, pages cached {cached}")
            def ms(rows):
                return ", ".join(f"{r[1]:.1f}" for r in rows)

            say("prefix", f"{label}: {len(got)} texts (token ids) equal to the uncached "
                f"engine's. Miss: {len(ids[0])} tokens, TTFT {got[0][1]:.1f} ms (uncached "
                f"{want[0][1]:.1f}), its lone stream {after_miss['blocks_dispatched'] - before['blocks_dispatched']} "
                f"decode blocks for 31 decode steps. Hits of {len(ids[1])}-{max(map(len, ids))} "
                f"tokens, pages matched {cached}: 4 at once TTFT {ms(got[1:5])} ms "
                f"(uncached {ms(want[1:5])}; admitted after "
                f"{', '.join(f'{r[2]:.1f}' for r in got[1:5])} ms); 4 more at once "
                f"{ms(got[5:9])} (uncached {ms(want[5:9])}); one alone {ms(got[9:])} "
                f"(uncached {ms(want[9:])}); decode blocks dispatched in each group "
                f"{blocks}; each group from an idle card, on {card}")
            if not mode.get("ragged_dispatch"):
                replays = stats["prefill_graph_replays"] - before["prefill_graph_replays"]
                eager = stats["prefill_eager"] - before["prefill_eager"]
                check(replays > 0 and eager == 0,
                      f"prefix {label}: {replays} prefill replays, {eager} eager")
                say("prefix", f"{label}: {replays} prefill graph replays, {eager} eager "
                    f"prefills; capture {stats['graph_capture_s']:.2f} s, pool "
                    f"{stats['graph_pool_bytes'] / 2**20:.1f} MiB")
            if extra.get("host_kv_bytes"):
                _host_tier(engine, miss, want[0], cold_other, page_bytes, card)
        finally:
            engine.shutdown()
    _round_trip(cfg, ps, card)
    counts = {name: k.launches for name, k in KERNELS.items()}
    say("prefix", f"kernel launches in this phase: {counts}")
    return {"launches": counts}


# The prefix cache's and host tier's page counts the mesh phase holds to the
# single-card engine's.
PREFIX_COUNTS = ("prefix_hit_tokens", "prefix_host_hit_tokens", "kv_pages_evicted",
                 "kv_pages_restored")
# The host-tier engine of the prefix phase (its bucketed bf16 mode): 160
# pages leave no room for a second header beside the first's cached pages.
PREFIX_HOST_TIER = dict(num_pages=160, prefix_cache_pages=1024, host_kv_bytes=1 << 30)


def _host_tier(engine, miss, cold_miss, cold_other, page_bytes, card) -> list:
    """A second header spills the first to the host tier; the first again
    faults its pages back, in place, to the uncached text. Returns the two
    requests' `_generate` rows."""
    ptrs = [t.data_ptr() for t in engine.paged.pools]
    _drain(engine)
    before = engine.stats()
    other = _generate(engine, [PREFIX_OTHER + PREFIX_TAILS[0]])
    check(other[0][0] == cold_other[0], "the second header's text differs from "
          "the uncached engine's")
    ids = np.asarray(engine.tokenizer.encode(miss), np.int32)
    dev, host = engine._prefix.probe_tiered(ids)
    spilled = engine.stats()["kv_pages_evicted"] - before["kv_pages_evicted"]
    check(spilled > 0 and host > 0, f"nothing spilled: {spilled} pages, header "
          f"device {dev} / host {host} tokens")
    _drain(engine)
    again = _generate(engine, [miss])
    stats = engine.stats()
    restored = stats["kv_pages_restored"] - before["kv_pages_restored"]
    check(again[0][0] == cold_miss[0], "the restored header's text differs from the "
          "uncached engine's")
    check(restored > 0, "no page was restored")
    check([t.data_ptr() for t in engine.paged.pools] == ptrs,
          "a restore moved the pools (the graphs read the captured addresses)")
    say("prefix", f"host tier: {spilled} pages spilled ({stats['kv_host_capacity']} host "
        f"pages of {page_bytes / 2**20:.2f} MiB), header then {dev // 16} pages on the "
        f"device and {host // 16} in host memory; sent again: {restored} pages restored "
        f"({restored * page_bytes / 2**20:.1f} MiB), kv_restore_ms p50 "
        f"{stats['kv_restore_ms_p50']} p95 {stats['kv_restore_ms_p95']} (host wall of "
        f"the issue), TTFT {again[0][1]:.1f} ms against {cold_miss[1]:.1f} ms recomputed "
        f"cold; text equal to the uncached engine's; the pools kept their addresses; on "
        f"{card}")
    return other + again


def _round_trip(cfg, ps, card) -> None:
    """64 pages gathered to a pinned host pool and restored into 64 others
    equal the originals bit for bit, bf16 and int8 (values and scales);
    the restore's device time from its issue (host wall apart)."""
    from polykey_tpu_torch.engine.engine import gather_to_host, restore_from_host
    from polykey_tpu_torch.engine.kv_cache import HostKVPool, init_paged_kv

    n = 64
    gen = torch.Generator(device="cuda").manual_seed(5)
    for int8 in (False, True):
        paged = init_paged_kv(cfg, 2 * n + 1, ps, torch.bfloat16, "cuda",
                              kv_dtype=torch.int8 if int8 else None)
        for t in paged.pools:
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=gen, device="cuda",
                                      dtype=torch.int8))
            else:
                t.copy_(torch.randn(t.shape, generator=gen, device="cuda").to(t.dtype))
        src, dst = list(range(1, n + 1)), list(range(n + 1, 2 * n + 1))
        host = HostKVPool(cfg, n, ps, torch.bfloat16, int8, pin=True)
        hosts = gather_to_host(paged, src)
        for r in range(n):
            host.write(r, *(h[:, r] for h in hosts), *([None] * (4 - len(hosts))))
        ptrs = [t.data_ptr() for t in paged.pools]
        times, walls = [], []
        for _ in range(3):
            sync()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            restore_from_host(paged, host, list(range(n)), dst)
            walls.append((time.perf_counter() - t0) * 1e3)
            end.record()
            sync()
            times.append(start.elapsed_time(end))
        ok = all(torch.equal(t[:, dst], t[:, src]) for t in paged.pools)
        check(ok, f"{'int8' if int8 else 'bf16'}: restored pages differ from the originals")
        check([t.data_ptr() for t in paged.pools] == ptrs, "the restore moved the pools")
        nbytes = sum(t[:, :n].numel() * t.element_size() for t in paged.pools)
        say("prefix", f"round trip, {'int8 KV (values and scales)' if int8 else 'bf16 KV'}: "
            f"{n} pages ({nbytes / 2**20:.1f} MiB) gathered to pinned host memory and "
            f"restored into {n} other pages, bit-exact; restore device time "
            f"{', '.join(f'{x:.3f}' for x in times)} ms (issue to done), host wall of "
            f"the issue {', '.join(f'{x:.3f}' for x in walls)} ms; {nbytes / 1e9 / (statistics.median(times) / 1e3):.1f} GB/s; on {card}")
        del paged, host, hosts
        torch.cuda.empty_cache()


# -- phase 11 --------------------------------------------------------------

SPEC_GREEDY = [SHORT[0], SHORT[1], LONG[0], LONG[1], LONG_DOC]
# The spec sub-phases the mesh phase serves again over a one-rank group:
# (c), the 1B draft over int8 KV, bucketed; (d), the 1B draft in ragged
# mode over bf16 KV (ragged x spec). Their EngineConfig fields.
MESH_SPEC = {"(c)": dict(kv_dtype="int8", draft_model="llama-3.2-1b"),
             "(d)": dict(draft_model="llama-3.2-1b", ragged_dispatch=True)}
SPEC_SAMPLED = [SHORT[1], LONG[0], LONG[1], SHORT[0]]
NEAR_TIE = 0.12     # the slices' kernel-against-plain logit tolerance


class _Tap(queue.Queue):
    """A request's output queue that also keeps the token ids it carried
    (the gRPC text of a random-weight model loses ids outside the byte
    range)."""

    def __init__(self):
        super().__init__()
        self.ids = []

    def put(self, item, *args, **kwargs):
        if item[0] == "token":
            self.ids.append(item[1])
        super().put(item, *args, **kwargs)


class _Grpc:
    """The engine behind the port's gRPC server on a free local port; each
    request the gateway submits keeps its token ids (`_Tap`)."""

    def __init__(self, engine):
        import grpc

        from polykey_tpu_torch.gateway.jsonlog import Logger
        from polykey_tpu_torch.gateway.server import build_server
        from polykey_tpu_torch.gateway.torch_service import TorchService
        from polykey_tpu_torch.proto import polykey_v2_pb2 as pk
        from polykey_tpu_torch.proto.polykey_v2_grpc import PolykeyServiceStub

        self.engine, self.pk, self.submitted = engine, pk, []
        submit = engine.submit

        def tapped(request):
            request.out = _Tap()
            self.submitted.append(request)
            submit(request)

        engine.submit = tapped
        logger = Logger(stream=sys.stderr, level="WARN")
        self.service = TorchService(engine, logger=logger)
        self.server, _health, port = build_server(self.service, logger,
                                                  address="127.0.0.1:0")
        self.server.start()
        self.channel = grpc.insecure_channel(f"127.0.0.1:{port}")
        self.stub = PolykeyServiceStub(self.channel)

    def generate(self, prompts: list, max_new: int = 32, stream: bool = False,
                 late: int = 0, **extra) -> list:
        """Send `prompts` at once (unary llm_generate, or ExecuteToolStream
        with `stream`), the last `late` of them only once every other one
        has its first token; returns, in order, (token ids, TTFT ms, tok/s,
        ms from submit to admission, ms to the first streamed chunk or
        None) of each, all of `max_new` tokens. TTFT is the engine's (a
        streamed request's final chunk carries it as usage); the first
        chunk is timed on this client's clock from the call, and comes with
        the first token that decodes to text (else it is the final one)."""
        start = len(self.submitted)
        errors: queue.Queue = queue.Queue()
        first_ms: dict = {}

        def one(prompt):
            try:
                req = self.pk.ExecuteToolRequest(
                    tool_name="llm_generate",
                    parameters=_struct(prompt=prompt, max_tokens=max_new, **extra))
                if stream:
                    t0, final = time.monotonic(), None
                    for chunk in self.stub.ExecuteToolStream(req, timeout=900):
                        first_ms.setdefault(prompt, (time.monotonic() - t0) * 1e3)
                        final = chunk if chunk.final else final
                    check(final is not None and final.status.code == 200,
                          f"stream ended without a final chunk of status 200: {final}")
                    check(final.usage.completion_tokens == max_new, f"usage {final.usage}")
                else:
                    resp = self.stub.ExecuteTool(req, timeout=900)
                    check(resp.status.code == 200, f"status {resp.status}")
            except BaseException as e:  # reported by the check below
                errors.put(repr(e))

        threads = [threading.Thread(target=one, args=(p,)) for p in prompts]
        early = len(prompts) - late
        for t in threads[:early]:
            t.start()
        deadline = time.monotonic() + 600
        while late and time.monotonic() < deadline and errors.empty() and not (
                len(self.submitted) - start >= early
                and all(r.out.ids for r in self.submitted[start:start + early])):
            time.sleep(0.002)
        for t in threads[early:]:
            t.start()
        for t in threads:
            t.join()
        check(errors.empty(), "request failed: " + "; ".join(list(errors.queue)))
        by_prompt = {r.prompt: r for r in self.submitted[start:]}
        out = []
        for p in prompts:
            r = by_prompt[p]
            t = r.timings
            check(len(r.out.ids) == max_new, f"{len(r.out.ids)} tokens, not {max_new}")
            out.append((r.out.ids, t.ttft_ms, t.tokens_per_sec,
                        (t.prefill_start - t.enqueued) * 1e3, first_ms.get(p)))
        return out

    def close(self) -> None:
        self.channel.close()
        self.server.stop(grace=5).wait()
        self.service.close()


def _near_tie(params, cfg, prompt_ids: list, common: list, a: int, b: int) -> float:
    """The target's logits on the plain eager path (the kill switches) over
    prompt + `common`, at the next position: the larger of tokens a's and
    b's distance below the top logit."""
    from polykey_tpu_torch.engine.kv_cache import init_paged_kv
    from polykey_tpu_torch.models.transformer import forward_paged, unembed

    ids = list(prompt_ids) + list(common)
    L, ps = len(ids), PAGE_SIZE
    npg = -(-L // ps)
    with _PlainPath(), torch.inference_mode():
        paged = init_paged_kv(cfg, npg + 1, ps, torch.bfloat16, "cuda")
        table = torch.arange(1, npg + 1, dtype=torch.int32, device="cuda")[None]
        tokens = torch.tensor([ids], dtype=torch.int32, device="cuda")
        pos = torch.arange(L, dtype=torch.int32, device="cuda")[None]
        hidden, _ = forward_paged(params, cfg, tokens, pos, paged, table)
        logits = unembed(params, cfg, hidden[0, -1:])[0].float()
    top = float(logits.max())
    return max(top - float(logits[a]), top - float(logits[b]))


def _hold_texts(label, params, cfg, tokenizer, prompts, got, want,
                against: str = "the plain engine's") -> int:
    """Each greedy text (ids) of `got` equal to `want`'s, or differing
    first at a near-tie: both tokens' target logits within NEAR_TIE of the
    top logit there, on the plain eager path. Returns the near-ties."""
    ties = 0
    for prompt, (ids, *_), (ref, *_) in zip(prompts, got, want):
        i = next((j for j, (x, y) in enumerate(zip(ids, ref)) if x != y), None)
        if i is None:
            continue
        margin = _near_tie(params, cfg, tokenizer.encode(prompt), ref[:i], ids[i], ref[i])
        say("spec", f"{label}: text differs from {against} at generated "
            f"token {i} ({ids[i]} against {ref[i]}): both within {margin:.4f} of the "
            f"top logit on the plain path (near-tie limit {NEAR_TIE})")
        check(margin <= NEAR_TIE, f"spec {label}: not a near-tie (margin {margin})")
        ties += 1
    return ties


def _time_ragged(engine) -> list:
    """Wrap the engine's ragged dispatch to record, for each call, (spec,
    live lanes, prefill ranges, CUDA events around it, host ms of the
    call): the events' span is the dispatch's wall on the card."""
    real, marks = engine._dispatch_ragged, []

    def timed(ranges, spec_candidates=None):
        lanes = int(engine._active.sum())
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        block = real(ranges, spec_candidates)
        b.record()
        marks.append((spec_candidates is not None, lanes, len(ranges), a, b, (time.perf_counter() - t0) * 1e3))
        return block

    engine._dispatch_ragged = timed
    return marks


def _ragged_walls(label: str, marks: list, card: str) -> None:
    """Print each ragged spec dispatch's live lanes, prefill ranges, wall on
    the card (the span of its events) and the host's time in the call;
    fails unless one carried verify lanes."""
    sync()
    spec = [m for m in marks if m[0]]
    check(any(m[1] > 0 for m in spec),
          f"spec {label}: no ragged spec dispatch carried a verify lane")
    say("spec", f"{label}: ragged spec dispatches (verify lanes, prefill ranges, wall "
        f"on the card ms, host ms of the call): "
        + "; ".join(f"({lanes}, {n}, {a.elapsed_time(b):.3f}, {host:.3f})"
                    for _, lanes, n, a, b, host in spec) + f" on {card}")


def phase_spec(seed: int, params, card: str, orbax_want: list = None) -> dict:
    """Speculative decoding on the serve phases' weights over gRPC (module
    docstring, phase 11): (a) a 1B draft over bf16 KV with the prefilter
    and the prefix cache, (b) the target as its own draft, (c) the 1B draft
    over int8 KV, (d) and (e) the 1B draft in ragged mode over bf16 and
    int8 KV, each beside the plain engine of its KV type. With
    `orbax_want` (the bf16 serve phase's one-at-a-time ids) the plain bf16
    engine is phase 7b's, read from the orbax checkpoint of the same
    weights (`orbax_engine`). Returns the plain engines' texts by KV type
    ("plain"), the kernel launches of each sub-phase ("launches") and
    phase 7b's ("orbax")."""
    from polykey_tpu_torch.engine.config import EngineConfig
    from polykey_tpu_torch.engine.engine import KERNELS, InferenceEngine
    from polykey_tpu_torch.models.config import get_config

    cfg = get_config("llama-3-8b")
    plain_texts, orbax = {}, {}
    for kv in ("", "int8"):
        if kv == "" and orbax_want is not None:
            with orbax_engine(seed, params, card, orbax_want, orbax) as eng:
                plain_texts[kv] = eng.generate(SPEC_GREEDY)
            continue
        eng = _Grpc(InferenceEngine(EngineConfig(model="llama-3-8b", kv_dtype=kv),
                                    params=params, device="cuda", seed=seed))
        try:
            plain_texts[kv] = eng.generate(SPEC_GREEDY)
        finally:
            eng.close()
    subs = [
        ("(a) 1B draft, bf16 KV", "", dict(draft_model="llama-3.2-1b",
                                            top_p_candidates=64, prefix_cache=True), None),
        ("(b) self-draft, bf16 KV", "", dict(draft_model="llama-3-8b",
                                              top_p_candidates=64), params),
        ("(c) 1B draft, int8 KV", "int8", dict(draft_model="llama-3.2-1b"), None),
        ("(d) 1B draft, ragged, bf16 KV", "", dict(draft_model="llama-3.2-1b",
                                                    ragged_dispatch=True), None),
        ("(e) 1B draft, ragged, int8 KV", "int8", dict(draft_model="llama-3.2-1b",
                                                        ragged_dispatch=True), None),
    ]
    launches = {}
    for label, kv, extra, draft in subs:
        config = EngineConfig(model="llama-3-8b", kv_dtype=kv, spec_gamma=4, **extra)
        for k in KERNELS.values():
            k.launches = 0
        t0 = time.monotonic()
        eng = _Grpc(InferenceEngine(config, params=params, device="cuda", seed=seed,
                                    draft_params=draft))
        try:
            engine = eng.engine
            ragged = config.ragged_dispatch
            marks = _time_ragged(engine) if ragged else []
            st = engine.stats()
            by = st["graph_pool_bytes_by_body"]
            say("spec", f"{label}: engine up in {time.monotonic() - t0:.1f} s; graphs "
                f"captured in {st['graph_capture_s']:.2f} s: {st['decode_graph_captures']} "
                f"decode, {st['prefill_graph_captures']} prefill, "
                f"{st['spec_graph_captures']} spec (rungs {engine._gamma_low}, "
                f"{engine._gamma_max}); pool {by.get('prefill', 0) / 2**20:.1f} MiB "
                f"before the spec keys, {st['graph_pool_bytes'] / 2**20:.1f} MiB after; "
                f"KV pools {st['kv_pool_bytes'] / 2**30:.4f} GiB target, "
                f"{st['draft_kv_pool_bytes'] / 2**30:.4f} GiB draft on {card}"
                + (f"; ragged spec stream widths {st['ragged_spec_width']}" if ragged else ""))
            # Ragged: the document goes in once the other four have their
            # first tokens, so its chunks ride with their verify windows.
            got = eng.generate(SPEC_GREEDY, late=1 if ragged else 0)
            greedy = engine.stats()
            ties = _hold_texts(label, params, cfg, engine.tokenizer, SPEC_GREEDY, got,
                               plain_texts[kv])
            acc = greedy.get("spec_acceptance", 0.0)
            lanes = max(1, greedy["spec_lane_rounds"])
            say("spec", f"{label}: 5 greedy texts equal to the plain engine's but at "
                f"{ties} near-ties; acceptance {acc} ({greedy.get('drafts_accepted', 0)}"
                f"/{greedy.get('drafts_proposed', 0)}), {greedy['spec_rounds']} rounds, "
                f"{greedy['spec_tokens'] / lanes:.3f} tokens a lane a round; TTFT "
                f"{', '.join(f'{r[1]:.1f}' for r in got)} ms (plain "
                f"{', '.join(f'{r[1]:.1f}' for r in plain_texts[kv])}); tok/s "
                f"{', '.join(f'{r[2]:.1f}' for r in got)} (plain "
                f"{', '.join(f'{r[2]:.1f}' for r in plain_texts[kv])}) on {card}")
            if draft is not None:
                check(acc >= 0.9, f"spec {label}: self-draft greedy acceptance {acc} < 0.9")
            if config.top_p_candidates:
                top_p = 0.7 if draft is not None else 0.9
                before = engine.metrics.snapshot()
                sampled = eng.generate(SPEC_SAMPLED, temperature=0.8, top_p=top_p, seed=5)
                after = engine.metrics.snapshot()
                prop = after["drafts_proposed"] - before["drafts_proposed"]
                acc_s = (after["drafts_accepted"] - before["drafts_accepted"]) / max(1, prop)
                check(prop > 0, f"spec {label}: no sampled round proposed a draft")
                say("spec", f"{label}: 4 sampled requests (temperature 0.8, top_p "
                    f"{top_p}, candidates 64) done, acceptance {acc_s:.4f} over {prop} "
                    f"drafts; tok/s {', '.join(f'{r[2]:.1f}' for r in sampled)}")
            if config.prefix_cache:
                hit0 = engine.stats()["prefix_hit_tokens"]
                again = eng.generate(SPEC_GREEDY[:1])
                hit = engine.stats()["prefix_hit_tokens"] - hit0
                check(hit > 0, f"spec {label}: the repeated prompt matched no cached page")
                # Its suffix's KV and first logits come from GEMMs of another
                # row count than the first run's group prefill: held as the
                # texts are, equal up to a near-tie.
                tie = _hold_texts(f"{label}, prefix hit", params, cfg, engine.tokenizer,
                                  SPEC_GREEDY[:1], again, got[:1], "its first run's")
                say("spec", f"{label}: the first greedy prompt again: {hit} tokens "
                    f"matched in the prefix cache, its 32 token ids equal to its first "
                    f"run's up to {tie} near-ties, TTFT {again[0][1]:.1f} ms")
            st = engine.stats()
            counts = {name: k.launches for name, k in KERNELS.items()}
            int8 = kv == "int8"
            dec = "paged_attention_decode_int8" if int8 else "paged_attention_decode"
            wr = "paged_write_int8" if int8 else "paged_write"
            say("spec", f"{label}: kernel launches {counts}; spec graph replays "
                f"{st['spec_graph_replays']}, eager rounds {st['spec_eager']}, prefill "
                f"replays {st['prefill_graph_replays']}, eager prefills "
                f"{st['prefill_eager']}; host stall p50 "
                f"{st.get('host_stall_ms_p50', 'not measured')} ms, p95 "
                f"{st.get('host_stall_ms_p95', 'not measured')} ms")
            check(st["spec_graph_replays"] > 0 and st["spec_eager"] == 0,
                  f"spec {label}: {st['spec_graph_replays']} round replays, "
                  f"{st['spec_eager']} eager")
            check(st["prefill_eager"] == 0, f"spec {label}: a prefill ran eagerly")
            check(counts[dec] > 0 and counts[wr] > 0,
                  f"spec {label}: the decode or write kernel did not launch: {counts}")
            rag = "ragged_paged_attention_int8" if int8 else "ragged_paged_attention"
            if ragged:
                say("spec", f"{label}: ragged dispatches {st['ragged_dispatches']}, of "
                    f"them {st['ragged_spec_dispatches']} ragged spec dispatches carrying "
                    f"{st['ragged_spec_verify_lanes']} verify windows in all; "
                    f"{st['ragged_behind_inflight']} went out behind a block in flight")
                _ragged_walls(label, marks, card)
                check(counts[rag] > 0 and st["ragged_dispatches"] > 0,
                      f"spec {label}: no ragged dispatch or kernel launch: {counts}")
                check(st["ragged_spec_verify_lanes"] > 0,
                      f"spec {label}: no verify window rode the ragged stream")
                check(counts["flash_attention"] == 0,
                      f"spec {label}: flash launched in ragged mode: {counts}")
            else:
                check(counts["ragged_paged_attention"] == 0
                      and counts["ragged_paged_attention_int8"] == 0,
                      f"spec {label}: a ragged kernel launched: {counts}")
            launches[label] = counts
            if label.startswith("(c)"):
                _spec_host_sync_ab(eng, label, card)
        finally:
            eng.close()
        sync()
    return {"plain": plain_texts, "launches": launches, "orbax": orbax.get("launches")}


# The spec_host_sync A/B's workload: one prompt alone, 16 tokens (a round
# of the random 1B draft yields about one token, about 0.12 s on the card),
# so every turn runs the same rounds.
SPEC_AB = [SHORT[0]]
SPEC_AB_TOKENS = 16


def _spec_host_sync_ab(grpc, label: str, card: str, turns: int = 2) -> None:
    """EngineConfig.spec_host_sync's A/B on the spec engine of sub-phase
    (c): SPEC_AB greedy, a request at a time, with the knob off and on in
    turns, `turns` each. The knob is read at each dispatch, so the engine's
    config is swapped between turns (while it is idle) and no second engine
    is built. Prints each turn's mean host stall, blocks_synced and tok/s;
    checks three timed reads a dispatched round with the knob on (none
    off), each landing in blocks_synced, and the same token ids in every
    turn."""
    t_ab = time.monotonic()
    engine, m = grpc.engine, grpc.engine.metrics
    off = engine.config
    on = replace(off, spec_host_sync=True)
    calls = {"rounds": 0, "syncs": 0}
    dispatch, on_sync = engine._dispatch_spec, m.on_spec_host_sync

    def counted_dispatch(*args, **kwargs):
        calls["rounds"] += 1
        return dispatch(*args, **kwargs)

    def counted_sync(stall_ms):
        calls["syncs"] += 1
        on_sync(stall_ms)

    engine._dispatch_spec, m.on_spec_host_sync = counted_dispatch, counted_sync
    streams = []
    try:
        for turn in range(2 * turns):
            knob = turn % 2 == 1
            engine.config = on if knob else off
            before, seen = m.counter_sample(), dict(calls)
            got = [grpc.generate([p], max_new=SPEC_AB_TOKENS)[0] for p in SPEC_AB]
            after = m.counter_sample()
            rounds = calls["rounds"] - seen["rounds"]
            syncs = calls["syncs"] - seen["syncs"]
            synced = after["blocks_synced"] - before["blocks_synced"]
            stall = after["host_stall_ms_total"] - before["host_stall_ms_total"]
            say("spec", f"{label}: spec_host_sync {'on' if knob else 'off'} (turn "
                f"{turn + 1} of {2 * turns}): {rounds} rounds dispatched, {syncs} "
                f"dispatch-time reads, blocks_synced +{synced}, host_stall_ms mean "
                f"{stall / max(1, synced):.3f} ms ({stall:.2f} ms in all); tok/s "
                f"{statistics.mean(r[2] for r in got):.1f} (per request "
                f"{', '.join(f'{r[2]:.1f}' for r in got)}) on {card}")
            check(rounds > 0, f"spec {label}: no spec round in the A/B's turn {turn + 1}")
            check(syncs == (3 * rounds if knob else 0),
                  f"spec {label}: {syncs} dispatch-time reads for {rounds} rounds with "
                  f"spec_host_sync {'on' if knob else 'off'}")
            check(synced >= syncs, f"spec {label}: blocks_synced +{synced} under the "
                  f"{syncs} reads")
            streams.append([r[0] for r in got])
    finally:
        engine.config = off
        del engine._dispatch_spec, m.on_spec_host_sync
    check(all(ids == streams[0] for ids in streams),
          f"spec {label}: the A/B's greedy streams differ between turns")
    say("spec", f"{label}: spec_host_sync A/B: {len(SPEC_AB)} greedy streams token for "
        f"token the same in all {2 * turns} turns; wall {time.monotonic() - t_ab:.1f} s")


# -- phase 12 --------------------------------------------------------------

def phase_generate(seed: int, params, card: str, plain: list) -> None:
    """Offline generation over a contiguous cache on the serve weights
    (module docstring, phase 12): `generate` greedy on LONG's two prompts,
    held to the plain engine's texts (`plain`, SPEC_GREEDY's order) under
    the near-tie rule; `speculative_generate` with the 1B draft and with
    the target as its own draft, held to `generate`'s."""
    from polykey_tpu_torch.engine.config import EngineConfig
    from polykey_tpu_torch.engine.sampling import SamplingParams
    from polykey_tpu_torch.engine.tokenizer import load_tokenizer
    from polykey_tpu_torch.models.config import get_config
    from polykey_tpu_torch.models.generate import generate
    from polykey_tpu_torch.models.speculative import speculative_generate
    from polykey_tpu_torch.models.transformer import init_params
    from polykey_tpu_torch.ops import flash_attention

    cfg = get_config("llama-3-8b")
    tokenizer = load_tokenizer(EngineConfig().tokenizer)
    prompts = [LONG[0], LONG[1]]
    want = [plain[SPEC_GREEDY.index(p)] for p in prompts]
    ids = [tokenizer.encode(p) for p in prompts]
    B, T, max_new, max_len = len(ids), max(len(x) for x in ids), 32, 1024
    check(min(len(x) for x in ids) >= 128, f"prompts of {[len(x) for x in ids]} tokens")
    tokens = torch.zeros((B, T), dtype=torch.int32)
    for b, x in enumerate(ids):
        tokens[b, :len(x)] = torch.tensor(x, dtype=torch.int32)
    tokens = tokens.cuda()
    lens = torch.tensor([len(x) for x in ids], dtype=torch.int32, device="cuda")
    sampling = SamplingParams(max_new_tokens=max_new)

    def timed(fn, *args, **kw):
        flash_attention.KERNEL.launches = 0
        sync()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        sync()
        return [x.cpu() for x in out], time.perf_counter() - t0, flash_attention.KERNEL.launches

    (out, n), wall, flash = timed(generate, params, cfg, tokens, lens, seed, sampling, max_len)
    check((n == max_new).all(), f"generate: num_generated {n.tolist()}")
    check(flash > 0, "generate: the flash kernel did not launch")
    rows = [(out[b].tolist(),) for b in range(B)]
    ties = _hold_texts("generate", params, cfg, tokenizer, prompts, rows, want)
    say("generate", f"generate: {B} prompts of {lens.tolist()} tokens (window {T}), "
        f"{max_new} greedy tokens each, cache of {max_len} positions: texts equal to the "
        f"plain engine's but at {ties} near-ties; flash launches {flash} "
        f"({cfg.num_layers} layers x the prefill); {wall:.2f} s, {B * max_new / wall:.1f} "
        f"tok/s over the batch ({max_new / wall:.1f} per row) on {card}")
    d_cfg = get_config("llama-3.2-1b")
    d_params = init_params(d_cfg, torch.bfloat16, "cuda",
                           torch.Generator(device="cuda").manual_seed(seed + 2))
    for label, dp, dc in (("1B draft", d_params, d_cfg), ("self-draft", params, cfg)):
        (s_out, s_n, acc, prop), s_wall, s_flash = timed(
            speculative_generate, params, cfg, dp, dc, tokens, lens, seed, sampling,
            max_len, gamma=4, return_stats=True)
        check((s_n == max_new).all(), f"speculative_generate {label}: {s_n.tolist()}")
        check(s_flash > 0, f"speculative_generate {label}: the flash kernel did not launch")
        s_rows = [(s_out[b].tolist(),) for b in range(B)]
        ties = _hold_texts(f"speculative_generate, {label}", params, cfg, tokenizer,
                           prompts, s_rows, rows, "generate's")
        say("generate", f"speculative_generate, {label}, gamma 4, greedy: texts equal "
            f"to generate's but at {ties} near-ties; acceptance {int(acc)}/{int(prop)} = "
            f"{int(acc) / max(1, int(prop)):.4f}; flash launches {s_flash}; {s_wall:.2f} s, "
            f"{B * max_new / s_wall:.1f} tok/s over the batch on {card}")
    del d_params


# -- phase 13: the serving shell --------------------------------------------

SHELL_WATCHDOG_S = 5.0   # the shell phase's watchdog window (a few seconds)


class _ShellClient:
    """The shell phase's gRPC client: the port's server built by
    build_server over TorchService.create (watchdog and supervisor) with
    an Observability bundle, the /metrics sidecar on an ephemeral port and
    the /debug surface on. Every engine the supervisor brings up is tapped
    (`_Tap`), so each submitted request keeps its token ids."""

    def __init__(self, engine, health, logger):
        import grpc

        from polykey_tpu_torch.gateway.server import build_server, start_metrics_server
        from polykey_tpu_torch.gateway.torch_service import TorchService
        from polykey_tpu_torch.obs import Observability
        from polykey_tpu_torch.proto import polykey_v2_pb2 as pk
        from polykey_tpu_torch.proto.health_v1_grpc import HealthStub
        from polykey_tpu_torch.proto.polykey_v2_grpc import PolykeyServiceStub

        self.pk, self.submitted = pk, []
        self.obs = Observability()
        self._tap(engine)
        self.service = TorchService.create(engine, health=health, logger=logger,
                                           obs=self.obs)
        self.service.supervisor.add_restart_listener(self._tap)
        self.server, self.health, port = build_server(
            self.service, logger, address="127.0.0.1:0", health=health, obs=self.obs)
        self.server.start()
        self.sidecar = start_metrics_server(self.obs, logger, service=self.service, port=0)
        check(self.sidecar is not None, "shell: the /metrics sidecar did not start")
        self.base = f"http://127.0.0.1:{self.sidecar.port}"
        self.channel = grpc.insecure_channel(f"127.0.0.1:{port}")
        self.stub = PolykeyServiceStub(self.channel)
        self.health_stub = HealthStub(self.channel)

    def _tap(self, engine) -> None:
        submit = engine.submit

        def tapped(request):
            request.out = _Tap()
            self.submitted.append(request)
            submit(request)

        engine.submit = tapped

    def get(self, path: str):
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(self.base + path, timeout=120) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def generate(self, prompts: list, trace_ids=None, max_new: int = 32) -> list:
        """Send `prompts` at once (unary llm_generate, greedy); returns, in
        order, (status code or None, details, trailers, the engine request)."""
        import grpc

        out: list = [None] * len(prompts)
        start = len(self.submitted)

        def one(i, prompt):
            req = self.pk.ExecuteToolRequest(
                tool_name="llm_generate",
                parameters=_struct(prompt=prompt, max_tokens=max_new))
            meta = (("x-trace-id", trace_ids[i]),) if trace_ids else ()
            try:
                resp, call = self.stub.ExecuteTool.with_call(req, timeout=900,
                                                             metadata=meta)
                out[i] = (resp.status.code, "", dict(call.trailing_metadata()))
            except grpc.RpcError as e:
                out[i] = (e.code(), e.details(), dict(e.trailing_metadata() or ()))

        threads = [threading.Thread(target=one, args=(i, p)) for i, p in enumerate(prompts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        by_prompt = {r.prompt: r for r in self.submitted[start:]}
        return [(*o, by_prompt.get(p)) for o, p in zip(out, prompts)]

    def close(self) -> None:
        self.channel.close()
        self.sidecar.stop()
        self.server.stop(grace=5).wait()
        self.service.close()


def _span_children(tree: dict) -> dict:
    return {c["name"]: c for c in tree.get("children", [])}


def _profile_during_request(client, prompt: str, card: str) -> dict:
    """A /debug/profile capture (torch.profiler, CPU and CUDA activity)
    while one request is served; returns what its trace holds."""
    result: dict = {}

    def capture():
        result["status"], result["body"] = client.get("/debug/profile?seconds=1.5")

    thread = threading.Thread(target=capture)
    thread.start()
    time.sleep(0.3)
    (status, _details, _tr, _req), = client.generate([prompt])
    thread.join()
    check(status == 200, f"shell: the request during the capture: {status}")
    check(result["status"] == 200, f"shell: /debug/profile answered {result['status']}")
    info = json.loads(result["body"])
    with open(info["trace"]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "GraphLaunch" in e.get("name", "")]
    cats: dict = {}
    for e in events:
        cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
    # The port's __global__ kernels (csrc/*.cu), by name.
    ours = {frag: sum(frag in e["name"] for e in kernels) for frag in (
        "flash_kernel", "paged_decode_kernel", "paged_write_kernel", "ragged_kernel")}
    arg_keys = sorted(kernels[0].get("args", {})) if kernels else []
    say("shell", f"/debug/profile (torch.profiler, 1.5 s, CPU and CUDA) during one "
        f"request: {len(events)} trace events by category {dict(sorted(cats.items(), key=str))}; "
        f"{len(kernels)} CUDA kernel events ({len({e['name'] for e in kernels})} kernel "
        f"names; the port's own {ours}), {len(launches)} cudaGraphLaunch calls; a kernel "
        f"event's args {arg_keys}; {os.path.getsize(info['trace'])} bytes on {card}")
    check(kernels, "shell: the profiler trace holds no CUDA kernel activity")
    return {"kernel_events": len(kernels), "graph_launches": len(launches), "ours": ours}


def phase_shell(seed: int, params, card: str) -> dict:
    """Llama-3-8B behind the full serving shell (module docstring, phase
    13): tracing, /metrics, reflection and the profiler before a fault;
    a step-stall that trips the watchdog and outlasts the supervisor's
    join window, so the old engine thread wakes while the fresh engine
    captures its graphs; the restarted engine's texts and kernels; then a
    prefill-error that fails one request and restarts nothing."""
    import tempfile

    import grpc

    from polykey_tpu_torch import faults
    from polykey_tpu_torch.engine.config import EngineConfig
    from polykey_tpu_torch.engine.engine import KERNELS, InferenceEngine
    from polykey_tpu_torch.gateway.health import HealthService
    from polykey_tpu_torch.gateway.jsonlog import Logger
    from polykey_tpu_torch.models.config import get_config
    from polykey_tpu_torch.proto import health_v1_pb2 as health_pb
    from polykey_tpu_torch.proto import reflection_v1alpha_pb2 as refl_pb

    phase = "shell"
    cfg = get_config("llama-3-8b")
    config = EngineConfig(model="llama-3-8b", watchdog_timeout_s=SHELL_WATCHDOG_S)
    saved = {k: os.environ.get(k) for k in ("POLYKEY_DEBUG_ENDPOINTS", "POLYKEY_PROFILE_DIR")}
    profile_dir = tempfile.mkdtemp(prefix="polykey-profile-")
    os.environ["POLYKEY_DEBUG_ENDPOINTS"] = "1"
    os.environ["POLYKEY_PROFILE_DIR"] = profile_dir
    health = HealthService()
    t0 = time.monotonic()
    engine = InferenceEngine(config, params=params, device="cuda", seed=seed, health=health)
    sync()
    alloc0 = torch.cuda.memory_allocated()
    capture_s = engine.stats()["graph_capture_s"]
    say(phase, f"engine up in {time.monotonic() - t0:.1f} s (graphs captured in "
        f"{capture_s:.2f} s), {alloc0 / 2**30:.2f} GiB allocated; watchdog window "
        f"{SHELL_WATCHDOG_S} s on {card}")
    client = _ShellClient(engine, health, Logger(stream=sys.stderr, level="WARN"))
    service, supervisor, obs = client.service, client.service.supervisor, client.obs
    service.watchdog.check_interval_s = 0.1
    supervisor.check_interval_s = 0.1
    tokenizer = engine.tokenizer
    try:
        # 1. Before any fault: the serve prompts, traced, as the first
        # concurrent group after the engine started.
        ids = [f"shell-{i}" for i in range(len(SPEC_GREEDY))]
        first = client.generate(SPEC_GREEDY, trace_ids=ids)
        for (status, details, trailers, _req), tid in zip(first, ids):
            check(status == 200, f"{phase}: {status} {details}")
            check(trailers.get("x-trace-id") == tid, f"{phase}: trace id echo {trailers}")
        traces = {t["trace_id"]: t for t in obs.recorder.traces()}
        starts = {e["trace_id"]: e["t"] for e in engine.timeline.events()
                  if e["kind"] == "slot_start"}
        for (_s, _d, _t, req), tid, prompt in zip(first, ids, SPEC_GREEDY):
            tree = traces[tid]
            kids = _span_children(tree)
            check(list(kids) == ["queue_wait", "prefill", "decode", "detokenize"],
                  f"{phase}: span tree {list(kids)}")
            t = req.timings
            # The prefill span ends when the lazily read first token
            # reached the host (the resolve), not at its dispatch.
            check(abs(kids["prefill"]["duration_ms"]
                      - (t.first_token - t.prefill_start) * 1e3) < 0.01
                  and abs(starts[tid] - t.first_token) < 0.01,
                  f"{phase}: the prefill span does not end at the first token's read")
            blocks = kids["decode"].get("children", [])
            say(phase, f"{tid} ({t.prompt_tokens} prompt tokens): span ms queue_wait "
                f"{kids['queue_wait']['duration_ms']:.3f}, prefill "
                f"{kids['prefill']['duration_ms']:.3f}, decode "
                f"{kids['decode']['duration_ms']:.3f} ({len(blocks)} blocks), "
                f"detokenize {kids['detokenize']['duration_ms']:.3f}; root "
                f"{tree['duration_ms']:.3f} on {card}")
        status, page = client.get("/metrics")
        check(status == 200 and b"polykey_ttft_ms_count 5\n" in page,
              f"{phase}: /metrics TTFT count is not 5 ({status})")
        call = client.channel.stream_stream(
            "/grpc.reflection.v1.ServerReflection/ServerReflectionInfo",
            request_serializer=refl_pb.ServerReflectionRequest.SerializeToString,
            response_deserializer=refl_pb.ServerReflectionResponse.FromString)
        (resp,) = list(call(iter([refl_pb.ServerReflectionRequest(list_services="")]),
                            timeout=60))
        listed = [s.name for s in resp.list_services_response.service]
        check(len(listed) == 4, f"{phase}: reflection lists {listed}")
        say(phase, f"x-trace-id echoed on all 5; /metrics polykey_ttft_ms_count 5; "
            f"reflection lists {listed}")
        profile = _profile_during_request(client, SHORT[0], card)
        before = [r[3].out.ids for r in first]

        # 2. A step-stall past the watchdog window and the supervisor's
        # join window: the old thread wakes while the fresh engine captures.
        join_s = supervisor.join_timeout_s
        # Trip after the window, the join window after it, then the fresh
        # engine's start; wake a few seconds into its capture (6-10 s).
        stall_s = round(SHELL_WATCHDOG_S + join_s + 0.5 + min(2.5, capture_s / 3), 1)
        watch: list = []

        def watch_health():
            try:
                for r in client.health_stub.Watch(
                        health_pb.HealthCheckRequest(service=""), timeout=300):
                    watch.append((time.monotonic(), r.status))
                    if len(watch) >= 3:
                        return
            except grpc.RpcError:
                pass

        watcher = threading.Thread(target=watch_health, daemon=True)
        watcher.start()
        old = service.engine
        exited: list = []

        def watch_thread():
            old._thread.join()
            exited.append(time.monotonic())

        threading.Thread(target=watch_thread, daemon=True).start()
        old._faults = faults.install(f"step-stall={stall_s}@1")
        t_fault = time.monotonic()
        (status, details, trailers, _req), = client.generate([SHORT[1]])
        failed_after = time.monotonic() - t_fault
        check(status == grpc.StatusCode.UNAVAILABLE,
              f"{phase}: the request in flight ended {status}: {details}")
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline and not (
                supervisor.restarts == 1 and not supervisor.orphans and exited):
            time.sleep(0.05)
        watcher.join(timeout=60)
        fresh = service.engine
        check(supervisor.restarts == 1 and fresh is not old,
              f"{phase}: {supervisor.restarts} restarts")
        check(not supervisor.orphans and old.paged is None,
              f"{phase}: the wedged engine's device state was not released")
        sync()
        alloc1 = torch.cuda.memory_allocated()
        c0, c1 = fresh._graphs.capture_window
        check(c0 <= exited[0] <= c1,
              f"{phase}: the old thread exited at {exited[0] - t_fault:.2f} s, outside "
              f"the fresh capture ({c0 - t_fault:.2f}-{c1 - t_fault:.2f} s)")
        states = [s for _, s in watch]
        check(states == [health_pb.HealthCheckResponse.SERVING,
                         health_pb.HealthCheckResponse.NOT_SERVING,
                         health_pb.HealthCheckResponse.SERVING],
              f"{phase}: health over Watch went {states}")
        status, page = client.get("/metrics")
        check(b"polykey_watchdog_stalls_total 1\n" in page
              and b"polykey_engine_restarts_total 1\n" in page,
              f"{phase}: /metrics stall or restart counter is not 1")
        kinds = [e["kind"] for e in obs.recorder.events()]
        check("watchdog_stall" in kinds and "engine_restart" in kinds,
              f"{phase}: flight recorder events {kinds}")
        note = fresh.timeline.events()[0]
        check(note["kind"] == "note" and note["note_kind"] == "engine_restart",
              f"{phase}: the fresh timeline opens with {note}")
        check(abs(alloc1 - alloc0) < 2**30,
              f"{phase}: {alloc1 / 2**30:.2f} GiB allocated after the restart, "
              f"{alloc0 / 2**30:.2f} before")
        trip = watch[1][0] - t_fault
        serving = watch[2][0] - watch[1][0]
        say(phase, f"step-stall {stall_s} s (window {SHELL_WATCHDOG_S} s, join "
            f"{join_s} s): in-flight request UNAVAILABLE after {failed_after:.2f} s "
            f"({details!r}); NOT_SERVING at {trip:.2f} s, SERVING {serving:.2f} s later "
            f"(trip to SERVING); the old thread woke at {exited[0] - t_fault:.2f} s, "
            f"inside the fresh capture {c0 - t_fault:.2f}-{c1 - t_fault:.2f} s "
            f"({fresh.stats()['graph_capture_s']:.2f} s); /metrics stalls 1, restarts 1; "
            f"allocated {alloc1 / 2**30:.2f} GiB after, {alloc0 / 2**30:.2f} before on "
            f"{card}")
        faults.clear()

        # The restarted engine: the same texts, through the same kernels.
        for k in KERNELS.values():
            k.launches = 0
        after = client.generate(SPEC_GREEDY)
        counts = {name: k.launches for name, k in KERNELS.items()}
        check(all(r[0] == 200 for r in after), f"{phase}: after the restart: {after}")
        check(all(counts[n] > 0 for n in BUCKETED)
              and not any(counts[n] for n in counts if n not in BUCKETED),
              f"{phase}: the fresh engine's launches {counts}")
        ties = _hold_texts(phase, params, cfg, tokenizer, SPEC_GREEDY,
                           [(r[3].out.ids,) for r in after], [(b,) for b in before],
                           "the first engine's")
        say(phase, f"restarted engine: 5 greedy texts equal to the first engine's but at "
            f"{ties} near-ties; kernel launches {counts}")

        # 3. prefill-error: one request fails, the others complete.
        fresh._faults = faults.install("prefill-error@1")
        (status, details, _tr, _req), = client.generate([SHORT[0]])
        check(status == grpc.StatusCode.UNKNOWN and "prefill failed" in details,
              f"{phase}: the prefill-error request ended {status}: {details}")
        rest = client.generate(SPEC_GREEDY[1:])
        check(all(r[0] == 200 for r in rest), f"{phase}: after the prefill error: {rest}")
        check(supervisor.restarts == 1 and fresh.dead is None and service.engine is fresh,
              f"{phase}: the prefill error restarted the engine")
        say(phase, f"prefill-error@1: one request failed ({details!r}), the next 4 "
            f"completed, no restart (restarts {supervisor.restarts})")
        return {"launches": counts, "profile": profile, "trip_s": trip,
                "to_serving_s": serving, "capture_s": fresh.stats()["graph_capture_s"]}
    finally:
        faults.clear()
        client.close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        import shutil

        shutil.rmtree(profile_dir, ignore_errors=True)


REPLICA_WATCHDOG_S = 2.0   # the replicas phase's watchdog window
REPLICA_STALL_S = 3.0      # its step-stall: past the window, inside the join


def _dev_client(argv: list) -> tuple[int, list, str]:
    """The port's dev client (python -m polykey_tpu_torch.gateway.client)
    with --raw-logs: (exit code, its JSON log lines, the Jest report the
    same lines render to)."""
    import contextlib
    import io

    from polykey_tpu_torch.gateway import client as dev_client
    from polykey_tpu_torch.gateway.beautify import print_jest_report

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = dev_client.main([*argv, "--raw-logs"])
    lines = out.getvalue().splitlines()
    report = io.StringIO()
    print_jest_report(lines, out=report)
    return rc, [json.loads(line) for line in lines if line.startswith("{")], report.getvalue()


def phase_replicas(seed: int, params, card: str, plain=None) -> dict:
    """Two Llama-3-8B replicas on one set of weight tensors behind the
    replica pool, the port's gRPC server and /metrics, with the signal
    plane and the autopilot (module docstring, phase 14). `plain` is the
    plain engine's SPEC_GREEDY texts (phase_spec's); None serves them here
    first on a single engine."""
    import grpc

    from polykey_tpu_torch import faults
    from polykey_tpu_torch.engine.autopilot import Autopilot, AutopilotConfig
    from polykey_tpu_torch.engine.config import EngineConfig
    from polykey_tpu_torch.engine.engine import KERNELS, GenRequest, InferenceEngine
    from polykey_tpu_torch.engine.replica_pool import SERVING, ReplicaPool
    from polykey_tpu_torch.gateway.client import trailers_from
    from polykey_tpu_torch.gateway.health import HealthService
    from polykey_tpu_torch.gateway.jsonlog import Logger
    from polykey_tpu_torch.gateway.server import build_server, start_metrics_server
    from polykey_tpu_torch.gateway.torch_service import TorchService
    from polykey_tpu_torch.models.config import get_config
    from polykey_tpu_torch.obs import Observability
    from polykey_tpu_torch.proto import polykey_v2_pb2 as pk
    from polykey_tpu_torch.proto.polykey_v2_grpc import PolykeyServiceStub

    phase = "replicas"
    cfg = get_config("llama-3-8b")
    if plain is None:
        eng = _Grpc(InferenceEngine(EngineConfig(model="llama-3-8b"), params=params,
                                    device="cuda", seed=seed))
        try:
            plain = eng.generate(SPEC_GREEDY)
        finally:
            eng.close()
        del eng
    config = EngineConfig(model="llama-3-8b", replicas=2, prefix_cache=True,
                          watchdog_timeout_s=REPLICA_WATCHDOG_S, signals_interval_s=0.5,
                          slo_policy="default", default_max_new_tokens=32)
    saved = os.environ.get("POLYKEY_DEBUG_ENDPOINTS")
    os.environ["POLYKEY_DEBUG_ENDPOINTS"] = "1"
    # Engines shut down by earlier phases are freed now, not in the first
    # capture's collection, so the memory the pool adds is measured.
    gc.collect()
    torch.cuda.empty_cache()
    sync()
    base_alloc = torch.cuda.memory_allocated()
    obs, health = Observability(), HealthService()
    logger = Logger(stream=sys.stderr, level="WARN")
    t0 = time.monotonic()
    # (a) Start: the engines one after the other, each capturing its graphs.
    pool = ReplicaPool.create(config, params=params, device="cuda", seed=seed,
                              health=health, logger=logger, obs=obs,
                              watchdog_interval_s=0.1, supervisor_interval_s=0.1)
    sync()
    up_s = time.monotonic() - t0
    alloc0 = torch.cuda.memory_allocated()
    engines = [rep.engine for rep in pool.replicas]
    check(all(e.params is params for e in engines),
          f"{phase}: the replicas do not serve the one set of weight tensors")
    captures = [e.stats()["graph_capture_s"] for e in engines]
    say(phase, f"2 replicas up in {up_s:.1f} s (graph captures {captures[0]:.2f} s, "
        f"{captures[1]:.2f} s), {alloc0 / 2**30:.2f} GiB allocated, "
        f"{(alloc0 - base_alloc) / 2**30:.2f} GiB of it the pool's ({base_alloc / 2**30:.2f} "
        f"GiB before: the shared weights); KV pool {engines[0].stats()['kv_pool_bytes'] / 2**30:.3f} "
        f"GiB and graph pool {engines[0].stats()['graph_pool_bytes'] / 2**30:.3f} GiB a replica "
        f"on {card}")
    # A knob set through the pool before the autopilot is armed: the
    # autopilot's setpoints start from it, and its restart listener must
    # re-apply it to a fresh replica (which boots with the config's 2).
    applied = pool.apply_engine_knobs({"lookahead": 3})
    check(applied == {"lookahead": 3} and all(e.knob_setpoints()["lookahead"] == 3
                                              for e in engines),
          f"{phase}: apply_engine_knobs applied {applied}")
    autopilot = Autopilot(pool, config=AutopilotConfig(interval_s=0.5), obs=obs,
                          logger=logger).start()
    service = TorchService.create(pool, health=health, logger=logger, obs=obs)
    service.autopilot = autopilot
    submitted: list = []
    submit = pool.submit

    def tapped(request):
        request.out = _Tap()
        submitted.append(request)
        submit(request)

    pool.submit = tapped
    server, health, port = build_server(service, logger, address="127.0.0.1:0",
                                        health=health, obs=obs)
    server.start()
    sidecar = start_metrics_server(obs, logger, service=service, port=0)
    check(sidecar is not None, f"{phase}: the /metrics sidecar did not start")
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    stub = PolykeyServiceStub(channel)
    addr = f"127.0.0.1:{port}"

    def get(path: str):
        import urllib.request

        with urllib.request.urlopen(f"http://127.0.0.1:{sidecar.port}{path}",
                                    timeout=60) as resp:
            return resp.status, resp.read()

    def by_prompt(prompt, start):
        return [r for r in submitted[start:] if r.prompt == prompt][-1]

    try:
        for k in KERNELS.values():
            k.launches = 0
        # (b) The dev client: its four checks on the mock tool, then each
        # greedy prompt streamed through llm_generate.
        rc, logs, report = _dev_client(["--server", addr])
        check(rc == 0 and "All 4 checks passed" in report,
              f"{phase}: the dev client's checks: rc {rc}\n{report}")
        start = len(submitted)
        served = []
        for prompt in SPEC_GREEDY:
            rc, logs, report = _dev_client(["--server", addr, "--tool", "llm_generate",
                                            "--prompt", prompt, "--stream"])
            check(rc == 0 and "All 4 checks passed" in report,
                  f"{phase}: dev client --stream: rc {rc}\n{report}")
            rep = [e for e in logs if e.get("msg") == "Served by replica"]
            done = [e for e in logs if e.get("msg") == "Streaming completed"]
            check(rep and done and done[0]["completion_tokens"] == 32,
                  f"{phase}: the dev client logged {logs}")
            served.append(rep[0]["replica"])
        got = [(by_prompt(p, start).out.ids,) for p in SPEC_GREEDY]
        check(all(len(ids) == 32 for (ids,) in got), f"{phase}: stream lengths")
        ties = _hold_texts(phase, params, cfg, engines[0].tokenizer, SPEC_GREEDY, got,
                           plain, "the plain engine's")
        say(phase, f"dev client: 4 checks passed, then 5 greedy streams (replicas "
            f"{served}) equal to the plain engine's but at {ties} near-ties")
        # A ~1024-token shared header, twice: the second request routes to
        # the replica that holds its pages.
        hits0 = pool.stats()["router_decisions"]["prefix-hit"]
        header_replicas = []
        for tail in PREFIX_TAILS[:2]:
            req = pk.ExecuteToolRequest(tool_name="llm_generate", parameters=_struct(
                prompt=PREFIX_HEADER + tail, max_tokens=16))
            resp, call = stub.ExecuteTool.with_call(req, timeout=300)
            check(resp.status.code == 200, f"{phase}: header request {resp.status}")
            header_replicas.append(trailers_from(call).get("replica"))
        hits = pool.stats()["router_decisions"]["prefix-hit"] - hits0
        _status, page = get("/metrics")
        line = [ln for ln in page.decode().splitlines()
                if ln.startswith('polykey_router_decisions_total{reason="prefix-hit"}')]
        check(hits == 1 and header_replicas[0] == header_replicas[1] and line,
              f"{phase}: header routes {header_replicas}, prefix hits {hits}, {line}")
        warmth = pool.replicas[int(header_replicas[0])].engine.prefix_warmth(
            engines[0].tokenizer.encode(PREFIX_HEADER + PREFIX_TAILS[2]))
        say(phase, f"shared 1023-token header: both requests on replica "
            f"{header_replicas[0]} (trailer), the second routed prefix-hit ({line[0]}); "
            f"that replica's warmth for a third tail {warmth:.3f}")

        # (c) Failover mid-stream: the replica streaming a greedy prompt
        # stalls past the watchdog window; the same RPC completes on the
        # other replica with the delivered tokens suppressed.
        victim_prompt = SPEC_GREEDY[2]
        ref_ids = got[2][0]
        sync()
        alloc1 = torch.cuda.memory_allocated()
        target = pool._route(GenRequest(prompt=victim_prompt), set())[0].index
        other = 1 - target
        other_engine = pool.replicas[other].engine
        pool.replicas[target].engine._faults = faults.install(
            f"slow-step=0.05:replica={target}")
        result: dict = {}

        def stream():
            req = pk.ExecuteToolRequest(tool_name="llm_generate", parameters=_struct(
                prompt=victim_prompt, max_tokens=32))
            call = stub.ExecuteToolStream(req, timeout=300)
            try:
                result["chunks"] = list(call)
                result["trailers"] = trailers_from(call)
            except grpc.RpcError as e:
                result["error"] = (e.code(), e.details())

        start = len(submitted)
        thread = threading.Thread(target=stream)
        thread.start()
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not (
                len(submitted) > start and len(submitted[start].out.ids) >= 4):
            time.sleep(0.002)
        victim = submitted[start]
        delivered = len(victim.out.ids)
        t_arm = time.monotonic()
        pool.replicas[target].engine._faults = faults.install(
            f"slow-step=0.05:replica={target},step-stall={REPLICA_STALL_S}@1:replica={target}")
        thread.join(timeout=300)
        check("chunks" in result, f"{phase}: the stream failed: {result.get('error')}")
        trailers = result["trailers"]
        check(trailers.get("replica") == str(other) and trailers.get("restarted") == "1",
              f"{phase}: failover trailers {trailers}")
        faults.clear()
        ids = victim.out.ids
        check(len(ids) == 32, f"{phase}: {len(ids)} tokens after the failover")
        ties_c = _hold_texts(phase, params, cfg, engines[0].tokenizer, [victim_prompt],
                             [(ids,)], [(ref_ids,)], "the uninterrupted run's")
        supervisor = pool.replicas[target].supervisor
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not (
                supervisor.restarts == 1 and pool.replicas[target].state == SERVING
                and not autopilot.paused):
            time.sleep(0.01)
        fresh = pool.replicas[target].engine
        check(supervisor.restarts == 1 and pool.replicas[target].state == SERVING
              and fresh is not engines[target] and fresh.params is params,
              f"{phase}: replica {target} did not restart onto the shared weights")
        check(engines[target].paged is None, f"{phase}: the dead replica kept its pools")
        sync()
        alloc2 = torch.cuda.memory_allocated()
        check(abs(alloc2 - alloc1) < 0.1 * 2**30,
              f"{phase}: {alloc2 / 2**30:.3f} GiB allocated after the restart, "
              f"{alloc1 / 2**30:.3f} before")
        events = [e for e in obs.recorder.events() if e["kind"] == "replica_state"
                  and e.get("replica") == target]
        t_drain = next(e["monotonic"] for e in events if e["state"] == "DRAINING")
        t_serving = [e["monotonic"] for e in events if e["state"] == SERVING][-1]
        stats = pool.stats()
        check(stats["streams_resumed"] == 1 and stats["requests_rerouted"] >= 1,
              f"{phase}: pool stats {stats['streams_resumed']} resumed")
        say(phase, f"failover: step-stall {REPLICA_STALL_S} s on replica {target} (window "
            f"{REPLICA_WATCHDOG_S} s) after {delivered} streamed tokens; the RPC completed on "
            f"replica {other} (trailers replica={trailers['replica']}, restarted="
            f"{trailers['restarted']}), 32 token ids equal to the uninterrupted run's but "
            f"at {ties_c} near-ties; replica {target} DRAINING at {t_drain - t_arm:.2f} s, "
            f"SERVING {t_serving - t_drain:.2f} s later (trip to SERVING; fresh capture "
            f"{fresh.stats()['graph_capture_s']:.2f} s); allocated {alloc2 / 2**30:.3f} GiB "
            f"after, {alloc1 / 2**30:.3f} GiB before on {card}")

        # (d) Signals, metrics and the autopilot.
        knobs = fresh.knob_setpoints()
        setpoints = autopilot.snapshot()["setpoints"]
        check(knobs["lookahead"] == setpoints["lookahead"] >= 3,
              f"{phase}: the fresh replica's knobs {knobs}, autopilot setpoints {setpoints}")
        _status, page = get("/metrics")
        text = page.decode()
        for family in ("polykey_replica_state", "polykey_replicas_serving",
                       "polykey_router_decisions_total", "polykey_slo_budget_remaining_ratio",
                       "polykey_slo_burn_rate", "polykey_slo_breaches_total",
                       "polykey_autopilot_decisions_total", "polykey_autopilot_setpoint",
                       "polykey_autopilot_paused"):
            check(f"# TYPE {family} " in text, f"{phase}: /metrics lacks {family}")
        check('polykey_replicas_serving 2' in text
              and 'polykey_streams_resumed_total 1' in text,
              f"{phase}: /metrics pool families")
        status, body = get("/debug/slo")
        slo = json.loads(body)
        check(status == 200 and set(slo["replicas"]) == {"0", "1"}
              and "aggregate" in slo and "autopilot" in slo,
              f"{phase}: /debug/slo {sorted(slo)}")
        launches = _launches()
        check(all(launches[n] > 0 for n in BUCKETED)
              and not any(launches[n] for n in launches if n not in BUCKETED),
              f"{phase}: kernel launches {launches}")
        itl = {i: rep.engine.metrics.itl_hist.percentiles(50, 95)
               for i, rep in enumerate(pool.replicas)}
        agg = slo["aggregate"]
        freshest = next((agg[w] for w in ("1m", "5m", "1h") if agg.get(w)), {})
        say(phase, f"/metrics: pool, SLO and autopilot families present; /debug/slo "
            f"aggregate {sorted(agg)} (1m: {freshest.get('requests_completed')} completed, "
            f"ttft p95 {freshest.get('ttft_ms_p95')} ms); slo "
            f"{ {k: v['burn_rate'] for k, v in slo['replicas'][str(other)]['slo'].items()} }; "
            f"autopilot setpoints {setpoints}, decisions "
            f"{autopilot.snapshot()['decisions_total']}; fresh replica's lookahead "
            f"{knobs['lookahead']} (re-applied; the config says 2)")
        say(phase, f"ITL p50/p95 ms per replica {itl} (replica {other} served on "
            f"through the restart); kernel launches {launches} on {card}")
        return {"launches": launches, "trip_to_serving_s": t_serving - t_drain,
                "capture_s": captures, "alloc_gib": (alloc0 / 2**30, alloc2 / 2**30)}
    finally:
        faults.clear()
        channel.close()
        sidecar.stop()
        server.stop(grace=5).wait()
        service.close()
        for rep in pool.replicas:
            if not rep.engine._thread.is_alive():
                rep.engine.release_device_state()
        if saved is None:
            os.environ.pop("POLYKEY_DEBUG_ENDPOINTS", None)
        else:
            os.environ["POLYKEY_DEBUG_ENDPOINTS"] = saved


# -- phase 15 --------------------------------------------------------------

DISAGG_KILL_AFTER = 8      # decode tokens the worker forwards before it dies
DISAGG_ITL_TOKENS = 320    # the stream decoded across the document's handoff


class _TimedTap(_Tap):
    """A `_Tap` that also stamps each token's arrival (monotonic)."""

    def __init__(self):
        super().__init__()
        self.times = []

    def put(self, item, *args, **kwargs):
        if item[0] == "token":
            self.times.append(time.monotonic())
        super().put(item, *args, **kwargs)


def _span_named(span, name: str):
    """The first span called `name` in `span`'s tree (depth first), or None."""
    if span.name == name:
        return span
    for child in list(span.children):
        found = _span_named(child, name)
        if found is not None:
            return found
    return None


def _handoff_split(request) -> dict:
    """One request's handoff, from its span tree (the coordinator's spans
    and the workers' grafted subtrees): gather and serialize on the
    prefill worker, the fetch socket hop to the coordinator, the ship
    socket hop to the decode worker (its deserialize apart), ms; bytes."""
    trace = request.trace
    ser = _span_named(trace, "handoff_serialize")
    fetch = _span_named(trace, "handoff_fetch")
    ship = [c for c in trace.children if c.name == "handoff_ship"]
    deser = _span_named(trace, "handoff_deserialize")
    check(ser is not None and fetch is not None and ship and deser is not None,
          f"disagg: the handoff spans are missing from {trace.to_dict()}")
    ship = ship[-1]
    deser_ms = deser.duration_ms
    return {"bytes": int(fetch.attrs["bytes"]), "gather_ms": float(ser.attrs["gather_ms"]),
            "serialize_ms": ser.duration_ms, "fetch_ms": fetch.duration_ms,
            "ship_ms": ship.duration_ms - deser_ms, "deserialize_ms": deser_ms}


def _http_get(port: int, path: str) -> tuple:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
        return resp.status, resp.read()


def _itl(times: list, lo: float, hi: float) -> tuple:
    """p50 and p95 (ms) of the gaps between tokens that arrived in [lo, hi],
    and how many gaps."""
    gaps = [(b - a) * 1e3 for a, b in zip(times, times[1:]) if lo <= a and b <= hi]
    if not gaps:
        return float("nan"), float("nan"), 0
    return (float(np.percentile(gaps, 50)), float(np.percentile(gaps, 95)), len(gaps))


def phase_disagg(seed: int, card: str, fingerprint=None, plain=None) -> dict:
    """The disaggregated tiers on the card (module docstring, phase 15): a
    1x1 Llama-3-8B pool, each worker a real process holding its own
    weights drawn from `seed` (`fingerprint`: the parent's, taken before it
    freed them), served over gRPC. `plain` is the plain engine's
    SPEC_GREEDY token ids (phase_spec's). Without them (the phase run
    alone) the weights are drawn here, the five served on a plain engine
    and freed first."""
    import shutil
    import signal
    import tempfile

    import grpc

    from polykey_tpu_torch.engine.config import EngineConfig
    from polykey_tpu_torch.engine.disagg_pool import DECODE, PREFILL, DisaggPool
    from polykey_tpu_torch.engine.replica_pool import SERVING
    from polykey_tpu_torch.engine.worker import WorkerConn
    from polykey_tpu_torch.gateway.client import trailers_from
    from polykey_tpu_torch.gateway.health import HealthService
    from polykey_tpu_torch.gateway.jsonlog import Logger
    from polykey_tpu_torch.gateway.server import build_server, start_metrics_server
    from polykey_tpu_torch.gateway.torch_service import TorchService
    from polykey_tpu_torch.models.config import get_config
    from polykey_tpu_torch.models.transformer import init_params
    from polykey_tpu_torch.obs import Observability
    from polykey_tpu_torch.proto import polykey_v2_pb2 as pk
    from polykey_tpu_torch.proto.polykey_v2_grpc import PolykeyServiceStub

    phase = "disagg"
    cfg = get_config("llama-3-8b")
    t_phase = time.monotonic()
    if fingerprint is None or plain is None:
        from polykey_tpu_torch.engine.engine import InferenceEngine
        from polykey_tpu_torch.engine.worker import params_fingerprint

        params = init_params(cfg, torch.bfloat16, "cuda",
                             torch.Generator(device="cuda").manual_seed(seed))
        fingerprint = params_fingerprint(params)
        eng = _Grpc(InferenceEngine(EngineConfig(model="llama-3-8b"), params=params,
                                    device="cuda", seed=seed))
        try:
            plain = eng.generate(SPEC_GREEDY)
        finally:
            eng.close()
        eng.engine.release_device_state()
        del eng, params
        gc.collect()
        torch.cuda.empty_cache()
    state_dir = tempfile.mkdtemp(prefix="polykey-disagg-")
    # A worker restart (a process start: imports, weights, capture) takes
    # tens of seconds: re-routes wait for it.
    config = EngineConfig(model="llama-3-8b", disagg="1x1", default_max_new_tokens=32,
                          disagg_heartbeat_s=0.25, disagg_recovery_wait_s=300.0,
                          request_timeout_s=600.0)
    saved = {k: os.environ.pop(k, None) for k in ("POLYKEY_FAULTS", "POLYKEY_DEVICE")}
    obs, health = Observability(), HealthService()
    logger = Logger(stream=sys.stderr, level="WARN")
    pool = service = server = channel = sidecar = None
    procs: list = []
    free0, total = torch.cuda.mem_get_info()
    try:
        t0 = time.monotonic()
        # (a) Start: both workers spawned at once, each drawing its weights
        # and capturing its graphs in its own process.
        pool = DisaggPool.create(config, health=health, logger=logger, obs=obs, seed=seed,
                                 state_dir=state_dir, device="cuda", ready_timeout_s=400.0)
        up_s = time.monotonic() - t0
        procs = [w.proc for w in pool.workers]
        prefill_w = next(w for w in pool.workers if w.tier == PREFILL)
        decode_w = next(w for w in pool.workers if w.tier == DECODE)
        stats0 = {w.tier: pool._worker_stats(w) for w in pool.workers}
        for tier, st in stats0.items():
            check(st.get("weights_fingerprint") == fingerprint,
                  f"{phase}: the {tier} worker's weights {st.get('weights_fingerprint')} "
                  f"are not the parent's {fingerprint}")
            check(st.get("device", "").startswith("cuda") and st["pid"] != os.getpid(),
                  f"{phase}: the {tier} worker runs on {st.get('device')} in pid {st.get('pid')}")
        free1, _ = torch.cuda.mem_get_info()
        say(phase, f"1x1 pool up in {up_s:.1f} s: prefill worker (pid {stats0[PREFILL]['pid']}) "
            f"ready in {prefill_w.boot_s[0]:.1f} s, decode worker (pid {stats0[DECODE]['pid']}) "
            f"in {decode_w.boot_s[0]:.1f} s; each drew the parent's weights (fingerprint "
            f"{fingerprint}); per worker allocated / reserved GiB: "
            + ", ".join(f"{t} {st['cuda_allocated_bytes'] / 2**30:.2f} / "
                        f"{st['cuda_reserved_bytes'] / 2**30:.2f} (weights "
                        f"{st['weight_bytes'] / 2**30:.2f}, KV {st['kv_pool_bytes'] / 2**30:.2f}, "
                        f"graphs {st['graph_pool_bytes'] / 2**30:.2f}, capture "
                        f"{st['graph_capture_s']:.2f} s)" for t, st in stats0.items())
            + f"; the card's used memory {(total - free0) / 2**30:.2f} -> "
            f"{(total - free1) / 2**30:.2f} GiB on {card}")

        service = TorchService.create(pool, health=health, logger=logger, obs=obs)
        submitted: list = []
        submit = pool.submit

        def tapped(request):
            request.out = _TimedTap()
            submitted.append(request)
            submit(request)

        pool.submit = tapped
        server, health, port = build_server(service, logger, address="127.0.0.1:0",
                                            health=health, obs=obs)
        server.start()
        sidecar = start_metrics_server(obs, logger, service=service, port=0)
        check(sidecar is not None, f"{phase}: the /metrics sidecar did not start")
        channel = grpc.insecure_channel(f"127.0.0.1:{port}")
        stub = PolykeyServiceStub(channel)

        def stream(prompt: str, max_tokens: int = 32) -> tuple:
            req = pk.ExecuteToolRequest(tool_name="llm_generate", parameters=_struct(
                prompt=prompt, max_tokens=max_tokens))
            call = stub.ExecuteToolStream(req, timeout=900)
            chunks = list(call)
            check(chunks and chunks[-1].final and chunks[-1].status.code == 200,
                  f"{phase}: stream of {prompt[:30]!r} ended {chunks[-1] if chunks else None}")
            return [r for r in submitted if r.prompt == prompt][-1], trailers_from(call)

        # (b) The five greedy prompts, one at a time (~100, ~100, ~390, ~390
        # and 1509 tokens): ids against the plain engine's, each handoff's
        # bytes and time by part.
        got, splits = [], []
        for prompt in SPEC_GREEDY:
            request, trailers = stream(prompt)
            check(trailers.get("tier") == "prefill=0,decode=0"
                  and trailers.get("replica") == "0" and "restarted" not in trailers,
                  f"{phase}: trailers {trailers}")
            check(len(request.out.ids) == 32, f"{phase}: {len(request.out.ids)} tokens")
            got.append(request.out.ids)
            splits.append(_handoff_split(request))
        imports = pool._worker_stats(decode_w)["handoff_import_ms"]
        check(len(imports) == len(SPEC_GREEDY), f"{phase}: imports {imports}")
        page_bytes = cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim * 2 * PAGE_SIZE
        for prompt, split, imp, request in zip(SPEC_GREEDY, splits, imports, submitted[-5:]):
            n = request.timings.prompt_tokens
            check(split["bytes"] > -(-n // PAGE_SIZE) * page_bytes,
                  f"{phase}: a {n}-token blob of {split['bytes']} bytes")
            say(phase, f"{n}-token prompt: blob {split['bytes']} B ({-(-n // PAGE_SIZE)} pages); "
                f"handoff ms: gather {split['gather_ms']:.2f}, serialize "
                f"{split['serialize_ms']:.2f}, socket to the coordinator "
                f"{split['fetch_ms']:.2f}, to the decode worker {split['ship_ms']:.2f}, "
                f"deserialize {split['deserialize_ms']:.2f}, import {imp:.3f} (device); "
                f"TTFT {request.timings.ttft_ms:.1f} ms on {card}")

        # (c) Decode ITL while the prefill worker prefills the document and
        # while its blob travels and is imported: a lone greedy stream, the
        # document sent once the stream has 24 tokens.
        sent: dict = {}

        def doc() -> None:
            sent["t"] = time.monotonic()
            sent["request"], _ = stream(LONG_DOC, max_tokens=4)

        def long_stream() -> None:
            sent["long"], _ = stream(SHORT[0], max_tokens=DISAGG_ITL_TOKENS)

        runner = threading.Thread(target=long_stream)
        runner.start()
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline and not (
                submitted and submitted[-1].prompt == SHORT[0]
                and len(submitted[-1].out.times) >= 24):
            time.sleep(0.002)
        sender = threading.Thread(target=doc)
        sender.start()
        sender.join()
        runner.join()
        times = sent["long"].out.times
        doc_req = sent["request"]
        serialize = _span_named(doc_req.trace, "handoff_serialize")
        check(serialize is not None and len(times) == DISAGG_ITL_TOKENS
              and times[-1] > doc_req.timings.first_token,
              f"{phase}: the stream ({len(times)} tokens) did not outlast the document's "
              "handoff")
        # Windows on the coordinator's clock: the prefill (with its queue
        # and the gather) ends where the worker's serialize starts; the
        # handoff (serialize, both socket hops, deserialize and the import
        # on the decode worker) ends at the document's first token.
        t_prefill = serialize.start
        windows = {"before": _itl(times, times[0], sent["t"]),
                   "prefill": _itl(times, sent["t"], t_prefill),
                   "handoff": _itl(times, t_prefill, doc_req.timings.first_token),
                   "after": _itl(times, doc_req.timings.first_token, times[-1])}
        spans = {"prefill": (t_prefill - sent["t"]) * 1e3,
                 "handoff": (doc_req.timings.first_token - t_prefill) * 1e3}
        say(phase, "decode ITL p50 / p95 ms of a lone stream around the 1509-token "
            "document: " + "; ".join(
                f"{name} {w[0]:.2f} / {w[1]:.2f} ({w[2]} gaps"
                + (f", {spans[name]:.1f} ms" if name in spans else "") + ")"
                for name, w in windows.items())
            + f"; the prefill and decode workers share the card by time-slicing on {card}")

        # (d) A real kill: the decode worker calls os._exit after forwarding
        # DISAGG_KILL_AFTER tokens; the pool restarts the process and
        # re-ships the retained blob.
        victim_prompt, ref_ids = SPEC_GREEDY[2], got[2]
        admitted0 = pool._worker_stats(prefill_w)["requests_admitted"]
        handoffs0 = dict(pool.handoffs)
        old_pid = decode_w.proc.pid
        launches_dead = pool._worker_stats(decode_w)["kernel_launches"]
        with WorkerConn(decode_w.addr, timeout=10.0) as conn:
            reply, _ = conn.request({"op": "arm_faults", "spec":
                                     f"worker-exit={DISAGG_KILL_AFTER}@1:tier=decode"},
                                    timeout=10.0)
        check(reply.get("ok"), f"{phase}: arm_faults {reply}")
        t_kill = time.monotonic()
        request, trailers = stream(victim_prompt)
        resumed_s = time.monotonic() - t_kill
        check(decode_w.proc.pid != old_pid and decode_w.state == SERVING
              and len(decode_w.boot_s) == 2 and decode_w.restarts == 1,
              f"{phase}: the decode worker was not restarted (pid {decode_w.proc.pid}, "
              f"state {decode_w.state}, boots {decode_w.boot_s})")
        check(trailers.get("tier") == "prefill=0,decode=0" and trailers.get("restarted") == "1",
              f"{phase}: trailers after the kill {trailers}")
        admitted1 = pool._worker_stats(prefill_w)["requests_admitted"]
        check(admitted1 == admitted0 + 1, f"{phase}: the prefill worker admitted "
              f"{admitted1 - admitted0} requests for the killed stream (a re-prefill)")
        handoffs1 = dict(pool.handoffs)
        check(handoffs1["retried"] == handoffs0["retried"] + 1
              and handoffs1["ok"] == handoffs0["ok"] + 1 and pool.streams_resumed == 1,
              f"{phase}: handoffs {handoffs0} -> {handoffs1}, resumed {pool.streams_resumed}")
        ids = request.out.ids
        check(len(ids) == 32, f"{phase}: {len(ids)} tokens after the kill")
        say(phase, f"decode worker killed (os._exit after {DISAGG_KILL_AFTER} streamed tokens, "
            f"pid {old_pid}); restarted as pid {decode_w.proc.pid} in {decode_w.boot_s[1]:.1f} s; "
            f"the retained blob re-shipped (prefill admissions +1, handoffs retried "
            f"+1); the stream completed {resumed_s:.1f} s after the kill with trailers "
            f"tier={trailers['tier']}, restarted={trailers['restarted']}")
        status, page = _http_get(sidecar.port, "/metrics")
        text = page.decode()
        for line in ('polykey_replica_state{replica="0",state="SERVING",tier="decode"} 1',
                     'polykey_replica_state{replica="0",state="SERVING",tier="prefill"} 1',
                     'polykey_replicas_serving{tier="decode"} 1',
                     'polykey_handoffs_total{outcome="retried"} 1',
                     'polykey_streams_resumed_total 1'):
            check(line in text, f"{phase}: /metrics lacks {line!r}")
        check('polykey_requests_completed_total{replica="0",tier="prefill"}' in text
              and 'polykey_ttft_ms_count{replica="0",tier="decode"}' in text,
              f"{phase}: /metrics lacks the tier-labelled engine families")

        # (e) The merged timeline: three process rows and a handoff arc.
        trace = pool.merged_perfetto()
        rows = {e["args"]["name"] for e in trace["traceEvents"]
                if e.get("ph") == "M" and e.get("name") == "process_name"}
        starts = {e["id"] for e in trace["traceEvents"] if e.get("ph") == "s"}
        ends = {e["id"] for e in trace["traceEvents"] if e.get("ph") == "f"}
        check(rows == {"polykey coordinator", "polykey prefill-0", "polykey decode-0"},
              f"{phase}: merged timeline rows {rows}")
        check(starts & ends, f"{phase}: no handoff arc in the merged timeline")
        offsets = pool.clock_offsets()
        launches = {w.tier: pool._worker_stats(w)["kernel_launches"] for w in pool.workers}
        check(launches[PREFILL]["flash_attention"] > 0
              and all(launches_dead[n] > 0 and launches[DECODE][n] > 0
                      for n in ("paged_attention_decode", "paged_write")),
              f"{phase}: worker launches {launches}, the killed decode worker's {launches_dead}")
        say(phase, f"merged timeline: rows {sorted(rows)}, {len(starts & ends)} handoff arcs; "
            f"clock offsets (s) " + ", ".join(
                f"{r} {o['offset_s']:.6f} +- {o['uncertainty_s']:.6f}"
                for r, o in offsets.items() if o["offset_s"] is not None))
        say(phase, f"kernel launches in the workers (their stats replies): prefill "
            f"{launches[PREFILL]}, the killed decode worker {launches_dead}, the restarted "
            f"one {launches[DECODE]} on {card}")
        result = {"launches": {"prefill": launches[PREFILL], "decode": launches_dead,
                               "decode_restarted": launches[DECODE]},
                  "boot_s": {"prefill": list(prefill_w.boot_s), "decode": list(decode_w.boot_s)},
                  "splits": splits, "itl": windows, "up_s": up_s}
    finally:
        if channel is not None:
            channel.close()
        if sidecar is not None:
            sidecar.stop()
        if server is not None:
            server.stop(grace=5).wait()
        if service is not None:
            service.close()
        elif pool is not None:
            pool.shutdown()
        # Every worker process this phase started (restarts included) is
        # gone, its process group killed whatever the outcome.
        if pool is not None:
            procs += [w.proc for w in pool.workers if w.proc not in procs]
        for proc in procs:
            if proc is not None and proc.poll() is None:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except OSError:
                    pass
                proc.wait(timeout=30)
        for name in sorted(os.listdir(state_dir)) if os.path.isdir(state_dir) else ():
            if name.endswith(".log") and sys.exc_info()[0] is not None:
                with open(os.path.join(state_dir, name), errors="replace") as f:
                    tail = f.read()[-4000:]
                print(f"chip_smoke: {name}:\n{tail}", file=sys.stderr)
        shutil.rmtree(state_dir, ignore_errors=True)
        for key, value in saved.items():
            if value is not None:
                os.environ[key] = value
    alive = [p.pid for p in procs if p is not None and p.poll() is None]
    check(not alive and len(procs) == 3, f"{phase}: worker processes left {alive} of "
          f"{[p.pid for p in procs]}")
    # Held to the plain engine's ids; a difference must be a near-tie, read
    # from the same weights drawn again here (the workers are gone).
    ties = 0
    if any(a != b[0] for a, b in zip(got, plain)) or ids != ref_ids:
        params = init_params(cfg, torch.bfloat16, "cuda",
                             torch.Generator(device="cuda").manual_seed(seed))
        from polykey_tpu_torch.engine.tokenizer import load_tokenizer

        tokenizer = load_tokenizer("byte")
        ties = _hold_texts(phase, params, cfg, tokenizer, SPEC_GREEDY,
                           [(g,) for g in got], plain, "the plain engine's")
        ties += _hold_texts(phase, params, cfg, tokenizer, [victim_prompt], [(ids,)],
                            [(ref_ids,)], "the uninterrupted run's")
        del params
        gc.collect()
        torch.cuda.empty_cache()
    result["wall_s"] = time.monotonic() - t_phase
    result["ids"] = got
    say(phase, f"5 greedy streams through the pool equal to the plain engine's and the "
        f"resumed stream to the uninterrupted one but at {ties} near-ties; all "
        f"{len(procs)} worker processes gone; the phase took {result['wall_s']:.1f} s "
        f"on {card}")
    return result


def _gemma_restart(grpc_client, params, cfg, tokenizer, want: list, card: str) -> None:
    """One supervised step-stall restart of the served gemma-2-27b engine,
    shorter than the join window: its thread exits, so its pools and
    graphs must be freed before the fresh engine allocates (a second set
    does not fit). The fresh engine's greedy text of SPEC_GREEDY[0] is held
    to `want` under the near-tie rule."""
    from polykey_tpu_torch import faults
    from polykey_tpu_torch.engine.engine import GenRequest
    from polykey_tpu_torch.gateway.health import SERVING, HealthService
    from polykey_tpu_torch.gateway.jsonlog import Logger
    from polykey_tpu_torch.gateway.torch_service import TorchService
    from polykey_tpu_torch.obs import Observability

    phase = "serve-gemma"
    old = grpc_client.engine
    health = HealthService()
    health.set_serving_status("", SERVING)
    service = TorchService.create(old, health=health, obs=Observability(),
                                  logger=Logger(stream=sys.stderr, level="WARN"))
    service.watchdog.check_interval_s = 0.1
    service.supervisor.check_interval_s = 0.1
    try:
        window = old.config.watchdog_timeout_s
        stall_s = window + 2.0
        check(stall_s < service.supervisor.join_timeout_s, "the stall must end in the join")
        sync()
        torch.cuda.reset_peak_memory_stats()
        alloc0 = torch.cuda.memory_allocated()
        old._faults = faults.install(f"step-stall={stall_s}@1")
        t0 = time.monotonic()
        victim = GenRequest(prompt=SPEC_GREEDY[0], max_new_tokens=32)
        old.submit(victim)
        while (item := victim.out.get(timeout=300))[0] == "token":
            pass
        check(item[0] == "error" and item[1].startswith("engine"),
              f"{phase}: the stalled request ended {item}")
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline and service.supervisor.restarts < 1:
            time.sleep(0.05)
        up = time.monotonic() - t0
        fresh = service.engine
        check(service.supervisor.restarts == 1 and not service.supervisor.orphans
              and old.paged is None and fresh.params is old.params,
              f"{phase}: the restart did not go through the released path")
        sync()
        peak, alloc1 = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
        faults.clear()
        request = GenRequest(prompt=SPEC_GREEDY[0], max_new_tokens=32)
        fresh.submit(request)
        ids = []
        while (item := request.out.get(timeout=300))[0] == "token":
            ids.append(item[1])
        check(item[0] == "done" and len(ids) == 32, f"{phase}: after the restart {item}")
        ties = _hold_texts(phase, params, cfg, tokenizer, SPEC_GREEDY[:1], [(ids,)],
                           want[:1], "the plain engine's")
        say(phase, f"supervised restart (step-stall {stall_s} s, window {window} s, thread "
            f"not wedged): fresh engine serving {up:.2f} s after the stall began "
            f"(capture {fresh.stats()['graph_capture_s']:.2f} s), the dead engine's pools "
            f"freed first; allocated {alloc0 / 2**30:.2f} GiB before, {alloc1 / 2**30:.2f} "
            f"after, peak during the restart {peak / 2**30:.2f} GiB of "
            f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}; greedy text "
            f"equal to the plain engine's but at {ties} near-ties on {card}")
    finally:
        faults.clear()
        service.close()


# -- phase 17 --------------------------------------------------------------

def _hf_tensors(params, cfg) -> list:
    """(HF name, tensor, transpose) of each tensor of the port's tree, in
    HF's names and order: the reverse of models/loader.py's map."""
    from polykey_tpu_torch.models.loader import _hf_layer_map

    out = [("model.embed_tokens.weight", params["embed"], False)]
    layer_map = _hf_layer_map(cfg)
    for i, layer in enumerate(params["layers"]):
        for path, (pattern, transpose) in layer_map.items():
            node = layer
            for k in path:
                node = node[k]
            if "{e}" in pattern:
                out += [(pattern.format(i=i, e=e), node[e], transpose)
                        for e in range(cfg.num_experts)]
            else:
                out.append((pattern.format(i=i), node, transpose))
    out.append(("model.norm.weight", params["final_norm"], False))
    if not cfg.tie_embeddings:
        out.append(("lm_head.weight", params["lm_head"], True))
    return out


def write_hf_checkpoint(params, cfg, directory: str, shards: int = 2) -> int:
    """Write the port's parameter tree (fp tensors) as HF ships a
    checkpoint: HF tensor names, linears [out, in], `shards` safetensors
    files (model-0000i-of-0000n.safetensors, split by bytes) and
    model.safetensors.index.json. Each tensor is transposed where it lies
    and copied to the host alone. Returns the bytes of tensor data."""
    import struct

    from polykey_tpu_torch.models.loader import INDEX_FILE, SAFETENSORS_DTYPES

    dtype_names = {v: k for k, v in SAFETENSORS_DTYPES.items()}
    entries = _hf_tensors(params, cfg)
    sizes = [t.numel() * t.element_size() for _, t, _ in entries]
    total = sum(sizes)
    groups: list = [[] for _ in range(shards)]
    done = 0
    for entry, size in zip(entries, sizes):
        groups[min(shards - 1, done * shards // max(1, total))].append(entry)
        done += size
    weight_map = {}
    for n, group in enumerate(groups):
        fname = f"model-{n + 1:05d}-of-{shards:05d}.safetensors"
        header, offset = {}, 0
        for name, t, transpose in group:
            nbytes = t.numel() * t.element_size()
            header[name] = {"dtype": dtype_names[t.dtype],
                            "shape": list(t.shape[::-1] if transpose else t.shape),
                            "data_offsets": [offset, offset + nbytes]}
            offset += nbytes
            weight_map[name] = fname
        header["__metadata__"] = {"format": "pt"}
        blob = json.dumps(header, separators=(",", ":")).encode()
        blob += b" " * (-len(blob) % 8)
        with open(os.path.join(directory, fname), "wb") as f:
            f.write(struct.pack("<Q", len(blob)))
            f.write(blob)
            for _, t, transpose in group:
                t = (t.t() if transpose else t).contiguous().reshape(-1)
                f.write(t.view(torch.uint8).cpu().numpy().data)
    with open(os.path.join(directory, INDEX_FILE), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f,
                  indent=2)
    return total


def _leaves_of(tree) -> list:
    """The tensors of a parameter tree in a fixed order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves_of(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves_of(v)]
    return [tree]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _bit_equal(loaded, host) -> tuple[int, int]:
    """(tensors, bytes) of `loaded` (on the card) checked equal to `host`
    bit for bit, each loaded tensor copied to the host alone (the card has
    no room to spare beside a serving 27B engine)."""
    if isinstance(loaded, dict):
        check(set(loaded) == set(host), f"keys {sorted(loaded)} against {sorted(host)}")
        parts = [_bit_equal(loaded[k], host[k]) for k in loaded]
    elif isinstance(loaded, list):
        check(len(loaded) == len(host), f"{len(loaded)} layers against {len(host)}")
        parts = [_bit_equal(a, b) for a, b in zip(loaded, host)]
    else:
        check(loaded.dtype == host.dtype and loaded.shape == host.shape,
              f"{loaded.dtype} {tuple(loaded.shape)} against {host.dtype} "
              f"{tuple(host.shape)}")
        check(torch.equal(loaded.cpu().view(torch.int16), host.view(torch.int16)),
              f"a loaded tensor {tuple(loaded.shape)} differs from the one written")
        return 1, loaded.numel() * loaded.element_size()
    return sum(p[0] for p in parts), sum(p[1] for p in parts)


def _gemma_texts(label: str, got: list, plain: list, card: str) -> None:
    for name, rows in (("", got), ("plain ", plain)):
        say("serve-gemma", f"{label}: {name}TTFT "
            f"{', '.join(f'{r[1]:.1f}' for r in rows)} ms; first streamed chunk "
            f"{', '.join('none' if r[4] is None else f'{r[4]:.1f}' for r in rows)} ms; "
            f"admission waits {', '.join(f'{r[3]:.1f}' for r in rows)} ms; tok/s "
            f"{', '.join(f'{r[2]:.1f}' for r in rows)} on {card}")
    waits = [r[3] for r in got + plain if r[3] > 1000.0]
    if waits:
        say("serve-gemma", f"{label}: first waits over 1 s (ROADMAP C.3): {waits} ms")


def phase_serve_gemma(seed: int, card: str) -> None:
    """Gemma-2-27B in bf16 over streamed gRPC, plain and with a Gemma-2-2B
    draft loaded from a safetensors checkpoint (module docstring, phase
    13). The checkpoint's directory is removed at the end, whatever
    happened."""
    import shutil
    import tempfile

    from polykey_tpu_torch.engine import engine as engine_mod
    from polykey_tpu_torch.engine.config import EngineConfig
    from polykey_tpu_torch.engine.engine import KERNELS, InferenceEngine
    from polykey_tpu_torch.models.config import get_config
    from polykey_tpu_torch.models.quant import params_bytes
    from polykey_tpu_torch.models.transformer import init_params

    phase = "serve-gemma"
    tcfg, dcfg = get_config("gemma-2-27b"), get_config("gemma-2-2b")
    torch.cuda.reset_peak_memory_stats()
    root = tempfile.gettempdir()
    need, free = dcfg.num_params() * 2, shutil.disk_usage(root).free
    check(free > need + 2**30, f"{phase}: {free / 1e9:.2f} GB free under {root}; the "
          f"gemma-2-2b checkpoint needs {need / 1e9:.2f} GB and 1 GiB to spare")
    ckpt = tempfile.mkdtemp(prefix="polykey-gemma-2-2b-", dir=root)
    try:
        gen = torch.Generator(device="cuda").manual_seed(seed + 2)
        draft = init_params(dcfg, torch.bfloat16, "cuda", gen)
        t0 = time.monotonic()
        nbytes = write_hf_checkpoint(draft, dcfg, ckpt)
        files = sorted(os.listdir(ckpt))
        on_disk = sum(os.path.getsize(os.path.join(ckpt, f)) for f in files)
        say(phase, f"gemma-2-2b ({dcfg.num_layers} layers, {dcfg.num_params() / 1e9:.3f} B "
            f"parameters, random bf16 weights from seed + 2) written as an HF "
            f"checkpoint in {time.monotonic() - t0:.1f} s: {files}, {nbytes} bytes of "
            f"tensors, {on_disk} on disk under {root}")
        host_draft = _tree_map(lambda t: t.cpu(), draft)
        del draft
        torch.cuda.empty_cache()
        target = init_params(tcfg, torch.bfloat16, "cuda",
                             torch.Generator(device="cuda").manual_seed(seed))
        sync()
        base = torch.cuda.memory_allocated()
        say(phase, f"gemma-2-27b ({tcfg.num_layers} layers, "
            f"{tcfg.num_params() / 1e9:.3f} B parameters) drawn on the card from the "
            f"seed: {params_bytes(target)} bytes bf16 ({params_bytes(target) / 2**30:.2f} "
            f"GiB)")

        def plain_streams(grpc):
            engine = grpc.engine
            texts = grpc.generate(SPEC_GREEDY, stream=True)
            counts = {name: k.launches for name, k in KERNELS.items()}
            ran = {n for n, c in counts.items() if c}
            check(ran == set(BUCKETED), f"{phase}: launched {counts}, not {BUCKETED} alone")
            check(engine._graphs.eager_calls("decode") == 0 and engine.stats()["prefill_eager"] == 0,
                  f"{phase}: an eager decode block or prefill: {dict(engine._graphs.eager)}")
            _gemma_restart(grpc, engine.params, tcfg, engine.tokenizer, texts, card)
            return texts, engine.tokenizer

        plain = phase_serve(seed, card, params=target, model="gemma-2-27b", phase=phase,
                            then=plain_streams, watchdog_timeout_s=2.0)
        target = plain.pop("params")
        plain_texts, tokenizer = plain["then"]
        del plain
        gc.collect()
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated() - base
        say(phase, f"plain engine shut down: {left / 2**20:.1f} MiB more allocated than "
            f"before it started (its pools freed before the next engine starts)")
        check(left < 2**30, f"{phase}: the plain engine left {left} bytes allocated")

        loads: list = []
        real_load = engine_mod.load_checkpoint

        def timed_load(*args, **kwargs):
            t0 = time.monotonic()
            out = real_load(*args, **kwargs)
            sync()
            loads.append(time.monotonic() - t0)
            return out

        config = EngineConfig(model="gemma-2-27b", draft_model="gemma-2-2b",
                              draft_checkpoint_path=ckpt, spec_gamma=4,
                              top_p_candidates=64)
        for k in KERNELS.values():
            k.launches = 0
        engine_mod.load_checkpoint = timed_load
        t0 = time.monotonic()
        try:
            grpc = _Grpc(InferenceEngine(config, params=target, device="cuda", seed=seed))
        finally:
            engine_mod.load_checkpoint = real_load
        up = time.monotonic() - t0
        label = "gemma-2-27b + gemma-2-2b draft from its checkpoint, gamma 4"
        try:
            engine = grpc.engine
            st = engine.stats()
            alloc = torch.cuda.memory_allocated()
            n_t, n_b = _bit_equal(engine.draft_params, host_draft)
            say(phase, f"{label}: the loaded draft equals the drawn one bit for bit "
                f"({n_t} tensors, {n_b} bytes); checkpoint {on_disk} bytes loaded in "
                f"{loads[0]:.2f} s ({on_disk / loads[0] / 1e9:.2f} GB/s) on {card}")
            by = st["graph_pool_bytes_by_body"]
            say(phase, f"{label}: engine up in {up:.1f} s (graphs captured in "
                f"{st['graph_capture_s']:.2f} s: {st['decode_graph_captures']} decode, "
                f"{st['prefill_graph_captures']} prefill, {st['spec_graph_captures']} spec); "
                f"weights {st['weight_bytes']} bytes target, "
                f"{params_bytes(engine.draft_params)} draft; KV pools "
                f"{st['kv_pool_bytes'] / 2**30:.4f} GiB target, "
                f"{st['draft_kv_pool_bytes'] / 2**30:.4f} GiB draft ({config.num_pages} "
                f"pages); graph pool {by.get('prefill', 0) / 2**20:.1f} MiB before the "
                f"spec keys, {st['graph_pool_bytes'] / 2**20:.1f} MiB after; allocated "
                f"{alloc / 2**30:.2f} GiB of {torch.cuda.get_device_properties(0).total_memory / 2**30:.2f} "
                f"on {card}")
            got = grpc.generate(SPEC_GREEDY, stream=True)
            greedy = engine.stats()
            acc = greedy.get("spec_acceptance", 0.0)
            lanes = max(1, greedy["spec_lane_rounds"])
            say(phase, f"{label}: 5 greedy streams; acceptance {acc} "
                f"({greedy.get('drafts_accepted', 0)}/{greedy.get('drafts_proposed', 0)}), "
                f"{greedy['spec_rounds']} rounds, {greedy['spec_tokens'] / lanes:.3f} tokens "
                f"a lane a round on {card}")
            _gemma_texts(label, got, plain_texts, card)
            before = engine.metrics.snapshot()
            sampled = grpc.generate(SPEC_SAMPLED, stream=True, temperature=0.8, top_p=0.9,
                                    seed=5)
            after = engine.metrics.snapshot()
            prop = after["drafts_proposed"] - before["drafts_proposed"]
            check(prop > 0, f"{phase}: no sampled round proposed a draft")
            say(phase, f"{label}: 4 sampled streams (temperature 0.8, top_p 0.9, "
                f"candidates 64): acceptance "
                f"{(after['drafts_accepted'] - before['drafts_accepted']) / prop:.4f} over "
                f"{prop} drafts; tok/s {', '.join(f'{r[2]:.1f}' for r in sampled)}")
            st = engine.stats()
            counts = {name: k.launches for name, k in KERNELS.items()}
            say(phase, f"{label}: kernel launches {counts}; spec graph replays "
                f"{st['spec_graph_replays']}, eager rounds {st['spec_eager']}, decode "
                f"replays {st['decode_graph_replays']}, prefill replays "
                f"{st['prefill_graph_replays']}, eager prefills {st['prefill_eager']}; "
                f"memory allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB, peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
            check(st["spec_graph_replays"] > 0 and st["spec_eager"] == 0,
                  f"{phase}: {st['spec_graph_replays']} round replays, "
                  f"{st['spec_eager']} eager")
            check(st["prefill_eager"] == 0 and engine._graphs.eager_calls("decode") == 0,
                  f"{phase}: an eager prefill or block: {dict(engine._graphs.eager)}")
            check(counts["paged_attention_decode"] > 0 and counts["paged_write"] > 0,
                  f"{phase}: the decode or write kernel did not launch: {counts}")
            check(not any(counts[n] for n in counts if n not in BUCKETED),
                  f"{phase}: a kernel of another path launched: {counts}")
        finally:
            grpc.close()
        del grpc, engine
        gc.collect()
        torch.cuda.empty_cache()
        ties = _hold_texts(label, target, tcfg, tokenizer, SPEC_GREEDY, got, plain_texts)
        say(phase, f"{label}: 5 greedy texts equal to the plain engine's but at {ties} "
            f"near-ties")
    finally:
        shutil.rmtree(ckpt)


def _serve_requests(stub, pk, submitted: list, batch_invariant: bool = True,
                    engine=None) -> list[dict]:
    """After one warm-up request per bucket, 5 concurrent requests: two
    short prompts (bucket 128), two long (bucket 512), one ~1500-token
    document (chunked prefill); one streamed, the rest unary; then the
    first greedy prompt again, which must return the same text where the
    model is `batch_invariant` (otherwise it is sent twice alone, and the
    two texts must agree). With `engine`, each request's record also
    holds `run_lanes`: the concurrent run's mean live decode lanes per
    dispatched step, from the engine's lane counters."""
    specs = [
        ("short greedy", SHORT[0], dict(), False),
        ("short sampled stream", SHORT[1], dict(temperature=0.8, top_p=0.9,
                                                  top_k=50, seed=7), True),
        ("long greedy", LONG[0], dict(), False),
        ("long sampled", LONG[1], dict(temperature=1.0, top_p=0.95, seed=11), False),
        ("document greedy", LONG_DOC, dict(), False),
    ]
    # One request per bucket first, alone: the first prefill of each shape
    # pays one-time library set-up that is not serving latency.
    for prompt in (SHORT[0], LONG[0]):
        warm = stub.ExecuteTool(pk.ExecuteToolRequest(
            tool_name="llm_generate",
            parameters=_struct(prompt=prompt, max_tokens=4)), timeout=900)
        check(warm.status.code == 200, "warm-up request failed")
    out: list = [None] * len(specs)
    errors: queue.Queue = queue.Queue()

    def one(i, label, prompt, extra, stream):
        try:
            req = pk.ExecuteToolRequest(
                tool_name="llm_generate",
                parameters=_struct(prompt=prompt, max_tokens=32, **extra),
            )
            t0 = time.monotonic()
            if stream:
                text, final, first = "", None, None
                for chunk in stub.ExecuteToolStream(req, timeout=900):
                    if chunk.final:
                        final = chunk
                    else:
                        first = first or time.monotonic()
                        text += chunk.delta
                check(final is not None and final.status.code == 200,
                      f"{label}: no final chunk with status 200")
                u = final.usage
                check(u.completion_tokens == 32 and u.prompt_tokens > 0,
                      f"{label}: usage {u}")
                out[i] = dict(label=label, status=final.status.code, text=text,
                              prompt_tokens=u.prompt_tokens,
                              completion_tokens=u.completion_tokens,
                              ttft_ms=u.ttft_ms, tok_s=u.tokens_per_sec,
                              wall_s=time.monotonic() - t0)
            else:
                resp = stub.ExecuteTool(req, timeout=900)
                check(resp.status.code == 200, f"{label}: status {resp.status}")
                out[i] = dict(label=label, status=resp.status.code,
                              text=resp.string_output, wall_s=time.monotonic() - t0)
        except BaseException as e:  # reported by the caller's check below
            errors.put(f"{label}: {e!r}")

    threads = [threading.Thread(target=one, args=(i, *s)) for i, s in enumerate(specs)]
    lanes0 = engine.stats() if engine is not None else None
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(errors.empty(), "request failed: " + "; ".join(list(errors.queue)))
    run_lanes = None
    if engine is not None:
        lanes1 = engine.stats()
        steps = lanes1["steps_dispatched"] - lanes0["steps_dispatched"]
        check(steps > 0, "the concurrent run dispatched no decode step")
        run_lanes = (lanes1["lane_steps"] - lanes0["lane_steps"]) / steps
    # Unary responses carry no Usage: read the engine's record of each
    # request (the timings the streamed Usage is built from).
    by_prompt = {r.prompt: r.timings for r in submitted}
    for r, (_label, prompt, _extra, _stream) in zip(out, specs):
        t = by_prompt[prompt]
        check(t.completion_tokens == 32, f"{r['label']}: {t.completion_tokens} tokens")
        r.setdefault("prompt_tokens", t.prompt_tokens)
        r.setdefault("completion_tokens", t.completion_tokens)
        r.setdefault("ttft_ms", t.ttft_ms)
        r.setdefault("tok_s", t.tokens_per_sec)
        r["run_lanes"] = run_lanes
    stats = stub.ExecuteTool(pk.ExecuteToolRequest(tool_name="engine_stats"), timeout=60)
    check(stats.status.code == 200, "engine_stats failed")
    def again() -> str:
        resp = stub.ExecuteTool(pk.ExecuteToolRequest(
            tool_name="llm_generate",
            parameters=_struct(prompt=SHORT[0], max_tokens=32)), timeout=900)
        check(resp.status.code == 200, f"the repeated greedy prompt: {resp.status}")
        return resp.string_output

    want = out[0]["text"] if batch_invariant else again()
    check(again() == want, "the repeated greedy prompt returned other text")
    return out


# -- main ------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of weights and inputs")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    try:
        import polykey_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the polykey_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2

    from polykey_tpu_torch.engine.engine import KERNELS

    start = time.monotonic()
    done = phase_done(start)
    dev = phase_device()
    sync()
    phase_build()
    sync()
    done("phase_build")
    train = phase_train(args.seed, dev["smi"])
    done("phase_train")
    kernels = phase_kernels(args.seed)
    phase_slice(args.seed)
    sync()
    done("phase_slice")
    serves = {}
    params = None
    for ragged, int8 in ((False, False), (True, False), (False, True), (True, True)):
        out = phase_serve(args.seed, dev["smi"], ragged=ragged, params=params,
                          int8=int8)
        params = out.pop("params")
        serves[(ragged, int8)] = out
    done("phase_serve x4")
    mesh = phase_mesh(args.seed, params, dev["smi"])
    sync()
    done("phase_mesh")
    phase_graph(args.seed, params, dev["smi"])
    sync()
    done("phase_graph")
    phase_prefill_graph(args.seed, params, dev["smi"])
    sync()
    done("phase_prefill_graph")
    phase_prefix(args.seed, params, dev["smi"])
    sync()
    done("phase_prefix")
    spec = phase_spec(args.seed, params, dev["smi"], serves[(False, False)]["mesh_ref"]["ids"])
    sync()
    done("phase_spec")
    features = phase_mesh_features(args.seed, params, dev["smi"])
    sync()
    done("phase_mesh_features")
    phase_generate(args.seed, params, dev["smi"], spec["plain"][""])
    sync()
    done("phase_generate")
    shell = phase_shell(args.seed, params, dev["smi"])
    sync()
    done("phase_shell")
    replicas = phase_replicas(args.seed, params, dev["smi"], spec["plain"][""])
    sync()
    done("phase_replicas")
    mesh_replicas = phase_mesh_replicas(args.seed, params, dev["smi"])
    done("phase_mesh_replicas")
    from polykey_tpu_torch.engine.worker import params_fingerprint

    fingerprint = params_fingerprint(params)
    gc.collect()
    torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    disagg = phase_disagg(args.seed, dev["smi"], fingerprint, spec["plain"][""])
    sync()
    done("phase_disagg")
    mesh_disagg = phase_mesh_disagg(args.seed, dev["smi"], disagg["ids"])
    done("phase_mesh_disagg")
    mixtral = phase_serve(args.seed, dev["smi"], model="mixtral-8x7b", quantize=True,
                          phase="serve-mixtral")
    gc.collect()
    torch.cuda.empty_cache()
    mixtral_mesh = phase_mesh_mixtral(args.seed, mixtral["params"], dev["smi"])
    done("phase_mesh_mixtral")
    del mixtral["params"]
    gc.collect()
    torch.cuda.empty_cache()
    phase_serve_gemma(args.seed, dev["smi"])
    done("phase_serve_gemma")
    gc.collect()
    torch.cuda.empty_cache()
    lint = phase_graphlint(args.seed, dev["smi"])
    sync()
    done("phase_graphlint")
    gc.collect()
    torch.cuda.empty_cache()
    from polykey_tpu_torch.engine.roofline import CHIP_SPECS, detect_chip, grade

    chip = detect_chip()
    check(chip == CHIP_SPECS["h100-sxm"], f"detect_chip() gave {chip} for {dev['name']}")
    for int8 in (False, True):
        kv = "int8 KV" if int8 else "bf16 KV"
        kv_dtype = "int8" if int8 else "bfloat16"
        runs = [serves[(ragged, int8)]["requests"] for ragged in (False, True)]
        # The five streams decode together: the run's rate is the sum of
        # theirs, graded at the run's measured mean of live lanes (each
        # decode step reads the weights once for all of them) and the
        # streams' mean context.
        marks = [grade("llama-3-8b", "bfloat16", False, 8, kv_dtype,
                       sum(r["tok_s"] for r in run), run[0]["run_lanes"],
                       sum(r["prompt_tokens"] + r["completion_tokens"] / 2
                           for r in run) / len(run), chip=chip)
                 for run in runs]
        say("serve", f"{kv}, the concurrent run: tok/s (sum of the streams') bucketed "
            f"{sum(r['tok_s'] for r in runs[0]):.1f}, ragged "
            f"{sum(r['tok_s'] for r in runs[1]):.1f}; live lanes "
            f"({marks[0]['avg_lanes_source']}) bucketed {marks[0]['avg_lanes']}, ragged "
            f"{marks[1]['avg_lanes']}; MBU bucketed {marks[0]['mbu']}, ragged "
            f"{marks[1]['mbu']} ({chip.name}) on {dev['smi']}")
        for g in marks:
            check(g["avg_lanes_source"] == "measured" and g["mbu"] is not None
                  and g["mbu"] <= 1.05, f"{kv}: an MBU reading above 1.05: {g}")
        for bucketed, rag in zip(*runs):
            # The prefill's FLOPs over the request's own TTFT.
            pf = [grade("llama-3-8b", "bfloat16", False, 8, kv_dtype, r["tok_s"],
                        r["run_lanes"], r["prompt_tokens"] + r["completion_tokens"] / 2,
                        r["ttft_ms"], r["prompt_tokens"], chip=chip)
                  .get("prefill_mfu_at_ttft") for r in (bucketed, rag)]
            say("serve", f"{kv}, {bucketed['label']}: TTFT bucketed "
                f"{bucketed['ttft_ms']:.1f} ms, ragged {rag['ttft_ms']:.1f} ms; "
                f"tok/s bucketed {bucketed['tok_s']:.1f}, ragged {rag['tok_s']:.1f}; "
                f"prefill MFU at TTFT bucketed {pf[0]}, ragged {pf[1]} ({chip.name}) "
                f"on {dev['smi']}")
            check(all(m is not None and m <= 1.05 for m in pf),
                  f"{kv}, {bucketed['label']}: a prefill MFU reading above 1.05: {pf}")
    say("serve", f"KV pool: bf16 {serves[(False, False)]['kv_gib']:.4f} GiB, int8 "
        f"{serves[(False, True)]['kv_gib']:.4f} GiB (scales included)")
    say("serve-mixtral", f"mixtral-8x7b, int8 weights, bf16 KV: kernel launches "
        f"{mixtral['launches']}")
    say("shell", f"restarted engine's kernel launches {shell['launches']}; trip to "
        f"SERVING {shell['to_serving_s']:.2f} s, fresh capture {shell['capture_s']:.2f} s "
        f"on {dev['smi']}")
    say("disagg", f"worker kernel launches {disagg['launches']}; starts (s) "
        f"{disagg['boot_s']} (the decode worker's second: its restart) on {dev['smi']}")
    say("mesh", f"kernel launches {mesh['launches']} on {dev['smi']}")
    say("mesh", f"checkpoint sub-phase: kernel launches {mesh['checkpoint']} on {dev['smi']}")
    say("orbax", f"kernel launches {spec['orbax']} on {dev['smi']}")
    say("mesh", f"mixtral sub-phase: kernel launches {mixtral_mesh} on {dev['smi']}")
    say("mesh", f"replicas sub-phase: kernel launches {mesh_replicas} on {dev['smi']}")
    say("mesh", f"disagg sub-phase: kernel launches by worker {mesh_disagg} on {dev['smi']}")
    for sub, counts in features["launches"].items():
        say("mesh", f"{sub} sub-phase: kernel launches {counts} on {dev['smi']}")
    say("graphlint", f"kernel launches in the sweeps {lint['launches']} on {dev['smi']}")
    say("train", f"kernel launches {train['launches']}; step {train['step_ms']:.1f} ms "
        f"(median), peak {train['peak_gib']:.2f} GiB on {dev['smi']}")
    say("replicas", f"kernel launches {replicas['launches']}; trip to SERVING "
        f"{replicas['trip_to_serving_s']:.2f} s; allocated with both replicas "
        f"{replicas['alloc_gib'][0]:.3f} GiB, after the restart "
        f"{replicas['alloc_gib'][1]:.3f} GiB on {dev['smi']}")

    # Each kernel's launches come from the serve phase that runs it (the
    # first of SERVE_KERNELS' phases naming it).
    launches = {}
    for key, names in SERVE_KERNELS.items():
        for name in names:
            launches.setdefault(name, serves[key]["launches"][name])
    paged_src = "polykey_tpu_torch/csrc/paged_attention_decode.cu"
    ragged_src = "polykey_tpu_torch/csrc/ragged_paged_attention.cu"
    decode_tpu = "polykey_tpu/ops/paged_attention_kernel.py:349"
    ragged_tpu = "polykey_tpu/ops/ragged_paged_attention_kernel.py:387"
    write_src = "polykey_tpu_torch/csrc/paged_write.cu"
    write_tpu = "polykey_tpu/ops/paged_write_kernel.py:134"
    sources = {
        "flash_attention": ("polykey_tpu_torch/csrc/flash_attention.cu",
                            "polykey_tpu/ops/flash_attention.py:157"),
        "paged_attention_decode": (paged_src, decode_tpu),
        "paged_write": (write_src, write_tpu),
        "ragged_paged_attention": (ragged_src, ragged_tpu),
        "paged_attention_decode_int8": (paged_src, decode_tpu),
        "paged_write_int8": (write_src, write_tpu),
        "ragged_paged_attention_int8": (ragged_src, ragged_tpu),
    }
    summary = []
    for name in KERNELS:
        src, tpu = sources[name]
        entry = {"name": name, "route": "cuda", "source": src, "replaces": tpu,
                 "launches": launches[name]}
        entry.update(kernels[name])
        summary.append(entry)
    check(all(e["launches"] > 0 for e in summary), f"a kernel read 0 launches: {summary}")
    print(json.dumps({"kernels": summary}), flush=True)
    print(dev["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
