#!/usr/bin/env python3
"""Smoke test of recommendflow_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py            # all phases, one card

Phases, each printing one JSON line; any failure exits non-zero:

  1. build                  nvcc-builds every kernel of csrc/ (one process per
                            source, started together) and reports build time
                            and ptxas usage (registers, spills), and the
                            HGMMA (wgmma) count in grouped_topk's SASS;
  2. gather_rows            against its plain version, bitwise, at every
                            shape the main paths launch it at: the
                            bench_recall dim-64 table (770 MB bf16, 128-byte
                            rows) at one batch's 87,040 ids, the
                            bench_ranking dim-32 table (2.5 GB bf16, 64-byte
                            rows) at one batch of 2048's 106,496 ids, uniform
                            and Zipf(1.2), and both tables in their stored
                            layout (512-byte rows) at those ids' stored rows
                            (the trainer's split gather);
  3. grouped_score_max      against its plain version at Q = 4096,
                            N_pad = 1,048,576, D = 128: f32 ip and l2 (FP32
                            SIMT kernel), the bf16 corpus and the uint8 form
                            on the SQ8 codes of the same corpus (queries
                            q ⊙ scale, ip and l2) on bf16 tensor cores; max
                            abs diff <= 1e-4 (f32 sums in another order;
                            both sides round the queries of a bf16 or uint8
                            corpus to bf16, and those products are exact);
  4. scatter_add_rows       one batch's stored-row gradients (87,040 rows of
                            the [1,505,024, 256] bf16 table, duplicates summed)
                            into a zero table: bitwise;
  5. rowwise_adagrad_update that table gradient applied to the table: p
                            bitwise (the same f32 operations in the same
                            order, one rounding), acc within rtol 1e-6 (the
                            mean is summed in another order), untouched rows
                            bitwise;
  6. sparse_adagrad_apply   the same step from the compacted f32 sums: the
                            same tolerances;
 6b. combine_row_grads      the split update's grouped duplicate sum against
                            its plain version on Zipf(1.2) ids at Dssm's two
                            bench_recall tables, Dcn/Criteo's 23 tables and a
                            60,000-id table whose hot row's run crosses ~300
                            chunks: uid, valid and n_valid equal, sums within
                            1e-5 of max(1, max|sum|), bitwise across two
                            calls; one grouped call each (launches by table
                            count); the grouped call's graph replay timed
                            against the per-table PyTorch path it replaced;
  7. flash_attention        against its plain version, f32 and bf16: at the
                            encoder's shape [256, 12, 64, 64] (q, k, v the
                            strided split_heads views of [B, L, H*D], key
                            masks from the token lengths of 256 texts), and
                            at Lq = 77, Lk = 200 for D in {8, 16, 32, 64,
                            128, 256} (online 64-key steps; past 128 the
                            head dim in 128-wide chunks) with a batch row whose
                            keys are all masked, at Lq = 130, Lk = 33 and
                            Lq = 77, Lk = 128 (one-pass tiles), and at
                            [4, 12, 64, 64] with leading, middle and
                            trailing holes in the mask; f32 within 1e-5
                            absolute (exps and sums in another order), bf16
                            within 2^-6 * max|v| (p rounded to bf16 before
                            P.V, <= 2^-8 relative each, plus both outputs'
                            final rounding, <= 2^-8 of |out| <= max|v| each);
                            one head of 256 dims over the encoder's batch
                            timed beside its bytes bound and SDPA; and at
                            TabTransformer's bench_ranking shape [2048, 4,
                            52, 8] (no mask). Its gradient on the card (the
                            kernel forward, the vanilla maths' backward in
                            plain torch) against autograd through the plain
                            version, f32, at that shape and at the encoder's
                            with its key masks and a row whose keys are all
                            masked: within 1e-5 of max(1, max|grad|) (the
                            same f32 maths, summed in another order);
  8. slice                  Dssm at the full width of conf/bench_recall.yaml
                            (random weights from a seed): predict 1,048,576
                            synthetic rows at batch 1024, build the eval
                            corpus, search 4096 user vectors with
                            FlatSearcher(metric="cos") at topk [10, 100]; the
                            top-100 must agree with a plain matmul + topk
                            (scores within 1e-5, indices equal except among
                            scores within 1e-5); gather_rows and
                            grouped_score_max must have launched;
  9. train                  Trainer.fit on the same model (the config's
                            dropout, batches of 1024): split path with
                            strategy "dense", then "sparse_set", then
                            table_update="dense", ending with the recall
                            evaluation; finite losses, every kernel of the
                            path launched; then one more step per split
                            strategy whose table update is redone through
                            the plain versions on the same row gradients
                            (both under torch's deterministic algorithms, so
                            the duplicate sums add in one order: p bitwise,
                            acc within rtol 1e-6, untouched rows bitwise);
 10. ranking                Dcn at the full width of conf/bench_ranking.yaml
                            (26 hashed features x 2 branches in one dim-32
                            bf16 group of 39,000,052 rows stored as [R/8,
                            256], 2.5 GB; 13 numeric; cross 3, deep 512-256-
                            128, the config's dropout 0.2; random weights
                            from seed 0), batches of 2048 from
                            synthetic_batch: scores of 131,072 rows finite
                            and in (0, 1), gather_rows launched; then
                            Trainer.fit with the split planner ("auto"),
                            then "dense", then "sparse_set" (20 steps each
                            after 3 warm-up steps), then 20 "auto" steps on
                            Zipf(1.2) ids, each run ending with val_auc on
                            16 held-out batches: finite losses, val_auc in
                            [0, 1], kernels 1-4 launched; 256 rows' logits
                            within 1e-4 of the same weights on the CPU;
                            one more step per strategy on uniform and Zipf
                            ids redone through the plain versions (as in 9);
                            one predict batch's embed pass and one split-
                            path gather under CUDA's sync debug mode
                            ("error"): the host never waits on the card in
                            either (the ids were checked on the host);
                            both strategies' split_table_update timed at the
                            bench_recall (770 MB, 87,040 ids) and
                            bench_ranking (2.5 GB, 106,496 ids) shapes and at
                            half the ranking ids, the planner's cost model
                            fitted to them, and its choice at bench_ranking
                            the faster strategy; 10 steps per strategy
                            under torch.profiler (device idle share);
 11. train_options          training options at full width: Dcn on
                            conf/bench_ranking.yaml (the dim-32 bf16 group of
                            39,000,052 rows, 2.5 GB; batches of 2048, 106,496
                            ids) for 3 + 1 steps with table_update="sparse"
                            (the touched rows of the dense table gradient:
                            gather_rows, scatter_add_rows and
                            sparse_adagrad_apply launched, not
                            rowwise_adagrad_update), then with "dense"
                            (rowwise_adagrad_update, not
                            sparse_adagrad_apply); finite losses; one
                            touched-row step on a batch already on the card
                            under CUDA's sync debug mode ("error": the host
                            never waits); one more step whose table update
                            is redone through the plain versions on the same
                            dense gradient (p bitwise, acc within rtol 1e-6,
                            untouched rows bitwise); the legacy planner's two
                            updates timed by CUDA events on a batch's dense
                            gradient at both bench tables (bench_ranking's
                            2.5 GB at 106,496 ids, bench_recall's 770 MB at
                            87,040 ids on Dssm) and at half the ranking ids,
                            its choice the faster or within 5% of it, and its
                            constants fitted to them; Dssm on
                            conf/bench_recall.yaml (batches of 1024) for 3 + 1
                            steps under make_optimizer's adam, adamw,
                            adagrad, sgd and lamb with clip_norm 1.0 (the
                            tables elementwise: gather_rows and
                            scatter_add_rows launched, neither Adagrad
                            kernel) and make_partitioned_optimizer("adamw")
                            (rowwise_adagrad_update on the tables); a cosine
                            schedule with 2 warmup steps, whose LR after every
                            step equals make_lr_schedule's at that update
                            count (0 at the first); logQ on item_id at
                            1 << 20 buckets: the stream's step advances by
                            one a step and the buckets seen grow, finite
                            losses; the bf16 compute_dtype model's predict of
                            one batch within 2^-4 (row L2) of the f32 model
                            with the same weights; ms a step for each mode
                            and optimizer;
 12. long_runs              long runs at the full width of
                            conf/bench_recall.yaml (Dssm: the dim-64 group of
                            6,020,008 rows stored bf16, 770 MB; towers
                            512-256-128; the config's dropout; batches of
                            1024, 87,040 ids; random weights from seed 0;
                            split_strategy "auto") on a dataset of 2 epochs x
                            6 synthetic batches with a length and iter_from,
                            under torch's deterministic algorithms: run A
                            fits both epochs without a break; run B, with
                            install_preemption_handler and a validation set
                            that fails if read, gets SIGTERM while batch 3 is
                            drawn and must return preempted at a step in
                            [1, 4] with no epoch-end callback, its
                            preempt_dir/<step>.pt equal to the returned state
                            bit for bit; a fresh model and Trainer restore
                            the directory and finish at step 12 with tables,
                            accumulators, dense weights, Adam moments and
                            BatchNorm statistics bitwise equal to run A's;
                            gather_rows and the planner's update kernels
                            launched; the seconds from the signal to the
                            checkpoint on disk, its MB and the restore
                            seconds; then fit(profile_dir=, profile_steps=
                            (3, 6)) over 8 steps of the restored model writes
                            one Chrome trace holding 3 optimizer steps and
                            device events, with ms a step inside and outside
                            the window and the port's kernels the trace lists
                            beside their launches in the window; then
                            cli/train on 16 batches of 1024 from
                            generate_records writes a checkpoint,
                            cli/finetune --promotion_constraints
                            'val_hit@10=[-1, inf)' promotes it to online,
                            cli/predict --checkpoint online gives the
                            finetuned model's vectors within 1e-6, and
                            cli/finetune with 'val_hit@10=(-inf, -1)' raises
                            PromotionBlocked and writes no online; each
                            CLI's seconds;
 13. dispatch               the JAX trainer's multi-step dispatch as CUDA
                            graphs of the step (Trainer.train_steps,
                            fit(scan_steps=)), under torch's deterministic
                            algorithms: Dssm at the full width of
                            conf/bench_recall.yaml (batches of 1024, the
                            config's dropout 0.3, split "auto") fits 2 epochs
                            x 12 batches at scan_steps=8 and at 1 from one
                            initial state, bitwise (tables, accumulators,
                            dense weights, Adam moments, BatchNorm
                            statistics); a SIGTERM during step 10 (inside the
                            second stack) stops at step 11, and a fresh model
                            restored from the preempt checkpoint finishes
                            bitwise the uninterrupted run; then each path
                            below n steps eagerly (train_step) and as one
                            stack of train_steps (the first eager, the second
                            captured and replayed, the rest replays) from one
                            initial state, the states bitwise and the kernel
                            launches equal (counted through the replays), and
                            one stack more each way timed (ms a step), under
                            torch.profiler (the device's idle share; each of
                            kernels 1-4 and 6 listed in the graphed stack's
                            trace as often as the counts say, so the
                            replays' launches are observed) and under
                            CUDA's sync debug mode (host waits a step), with
                            each graph's capture seconds and pool MB: Dssm
                            (8 steps), Dcn at the full width of
                            conf/bench_ranking.yaml on Zipf(1.2) ids (batches
                            of 2048, 16 steps) under split "sparse_set",
                            split "dense", table_update="sparse" and the
                            whole-table table_update="dense" (and
                            "sparse_set" once more outside deterministic
                            algorithms, timed only), Dssm under
                            make_optimizer(1e-3, "lamb", clip_norm=1.0) and
                            under a cosine schedule with 2 warmup steps (each
                            step's LR on both paths equal to the schedule's,
                            exactly), TabTransformer at bench_ranking width
                            and SiameseEncoder on a BERT-Base (random
                            weights from seed 0 grafted as in phase 16) at
                            text_recall's shape (128 x 64 tokens), 8 steps
                            each; the eval forward through its graph
                            (Trainer.predict) bitwise the eager forward for
                            Dssm and Dcn, ms a batch each way, and ms a call
                            of predict on 4 batches eager, with a graph of
                            its own and with the trainer's; Dssm, Dcn and
                            TabTransformer traced on the card and served
                            from memory (ServingModel: the program's CUDA
                            graph) bitwise against the program's fx module
                            and the eager model on held batches, ms a batch
                            of each, and /predict of the served Dcn bitwise;
 14. ranking_zoo            DeepFm, XDeepFm, Cold, Mmoe, Essm, Escm2 (dr
                            and ips), TabTransformer and Esim at
                            conf/demo_ranking.yaml's widths, Din at
                            conf/demo_din.yaml's: three split steps
                            ("dense", "dense", "sparse_set": kernels 1-4
                            launched, and flash_attention for TabTransformer
                            and Esim, whose heads are 4 and 16 wide, Esim's
                            with key masks) with finite losses, and the eval
                            outputs within 1e-5 of the same weights on the
                            CPU; for Din, TabTransformer and Esim the
                            gradient check of phase 15;
 15. attention_ranking      TabTransformer at the full width of
                            conf/bench_ranking.yaml (Networks.class set in
                            code; the class defaults: 2 blocks of 4 heads,
                            MLP 128-64, dropout 0.1; 52 fields of dim 32 from
                            the dim-32 bf16 group of 39,000,052 rows, 13
                            numeric; random weights from seed 0), batches of
                            2048 from synthetic_batch, so flash_attention
                            runs at [2048, 4, 52, 8] f32 (split_heads views,
                            no mask), twice a forward: scores of 131,072
                            rows finite and in (0, 1) (gather_rows and
                            flash_attention launched); Trainer.fit with the
                            planner, 3 + 20 steps ending with val_auc on 16
                            held-out batches (finite losses, val_auc in [0,
                            1], kernels 1 and 6 and the planner's update
                            kernels launched); 256 rows' logits within 1e-4
                            of the same weights on the CPU; the gradient
                            check: one forward and backward of a batch at
                            dropout 0 on the card (f32), on a CPU copy (f32)
                            and on a CPU copy in f64 (the reference; the
                            table frozen on all three), every dense
                            parameter's gradient within 1e-4 of its largest
                            magnitude on the CPU (f32 GEMMs, TF32 off, summed
                            in another order) or, past that, no farther from
                            the f64 gradient than 8x the CPU f32's own
                            distance from it; an attention key bias (exact
                            gradient 0: softmax ignores a shift of a query's
                            whole row) below 1e-5 of the model's largest
                            gradient on the card and the CPU; a control run
                            on the card with kernel 6 dropping each row's
                            last valid key breaks that rule; and
                            tab.block0.mha.q.weight's gradient nonzero on
                            the card; predict ms a batch, ms a step and 10
                            steps under torch.profiler (device idle share);
 16. text_recall            SiameseEncoder on conf/demo_text_recall.yaml
                            (its features, loss, embedding_dim 64, dense
                            merge, cls pooling, batch 128) with
                            Networks.pretrained.encoder set in code to a
                            BERT-Base bert_config.json / pytorch_model.bin
                            written by write_bert_files (google-research/
                            bert's BERT-Base: 12 layers, 768 wide, 12 heads,
                            FFN 3072, the English vocabulary of 30,522;
                            random weights from seed 0) and both texts'
                            max_len set to 64, so flash_attention runs at
                            [128, 12, 64, 64] f32 with trailing-pad key
                            masks, 12 layers x 2 towers a forward, with its
                            backward; records from generate_records read
                            through the port's Dataset (host tokenizer,
                            trailing pads, :seg): after Trainer.init_state
                            the encoder equals the checkpoint's converted
                            tree bit for bit, and the gradient check of
                            phase 15 on 16 rows holds there; Trainer.fit for
                            3 + 20 steps (Adam at BERT's fine-tuning rate,
                            2e-5: at 1e-3 the fine-tune collapses) ending
                            with the recall@K evaluation (exact flat
                            top-k over the ~2,000 evaluation items: the
                            matmul path below 262,144 items, so
                            grouped_score_max does not run here): finite
                            losses, recall@K in [0, 1], flash_attention
                            launched;
                            predict of user and ad vectors (finite, unit);
                            16 rows' vectors within 1e-4 of a CPU copy; the
                            gradient check of phase 15 on the same 16 rows
                            (the token embedding's gradient nonzero);
                            flash_attention on the 24 layer inputs of one
                            evaluation batch (captured at the call) within
                            1e-5 of its plain version, its gradient within
                            1e-5 of max(1, max|grad|); 10 steps
                            under torch.profiler (idle share, device time by
                            kernel, host waits a step);
 17. simbert                SimBERT on BERT-Base (the random HF checkpoint of
                            encoder/synthetic.py:write_bert_files, vocab
                            21,128, as encode's) loaded by
                            load_pretrained_text_encoder: simbert_batches of
                            64 make_texts pairs in both orders, [128, 128]
                            token rows, the UniLM mask built on the card; a
                            late segment-1 token changes no earlier position
                            of its row, bit for bit; at dropout 0 the loss and
                            both parts within 1e-4 (relative) of the CPU and
                            every gradient by the gradient check of phase 15,
                            on 16 rows (a full batch costs the CPU minutes);
                            20 Adam steps (make_optimizer, 1e-4) on the batch
                            at dropout 0.1, each step's dropout seeded
                            explicitly: finite losses, the last below the
                            first; kernel 6 launched 0 times (full masks take
                            the vanilla maths); ms a step, 5 more steps under
                            torch.profiler (idle share, device ms by op class:
                            the tied LM head's GEMMs, the vanilla attention,
                            the encoder's GEMMs) and peak memory;
 18. matching_zoo           Mobius and Pdm on conf/demo_recall.yaml,
                            DssmEncoder and Que2Search on
                            conf/demo_text_recall.yaml, Dssm with an image
                            slot (tests/test_image.py's layout, written into
                            a temporary directory; pixels from
                            synthetic_batch), its patch projection and its
                            ViT (image_encoder: vit): three steps each
                            (kernels 1-4 where the model has tables, the
                            split path for Mobius and Dssm, the dense path
                            for Pdm and Que2Search; flash_attention for
                            Pdm, DssmEncoder, Que2Search and the ViT) with
                            finite losses, the eval outputs within 1e-5 of
                            the same weights on the CPU, and the gradient
                            check of phase 15, on the built weights and
                            after the three steps, for the models that run
                            flash_attention;
 19. export_serve           Dcn and TabTransformer at the full width of
                            conf/bench_ranking.yaml (batch 2048; kernel 6
                            at [2048, 4, 52, 8]) and Dssm at the full width
                            of conf/bench_recall.yaml (batch 1024), random
                            weights from seed 0: each traced by trace_model
                            on the card (labels baked in as zeroed
                            constants), written by save_export and loaded
                            by ServingModel.load on the card; the loaded
                            graph holds recflow::gather_rows (and
                            recflow::flash_attention for TabTransformer)
                            and launches each kernel once a node and batch;
                            its outputs on 4 held batches within 1e-6 of
                            the eager model (0 expected: the same kernels
                            and ATen ops), finite, scores in (0, 1); export,
                            save and load s, the artifact's MB, predict ms
                            per batch beside the eager model's; then the
                            loaded Dcn behind EncodeServer + make_server on
                            127.0.0.1: /health lists /predict, one and 4
                            concurrent /predict requests bitwise equal to
                            ServingModel.predict of the same batch, an id
                            outside its table answered 400 and the next
                            request still answered bitwise, single-request
                            latency; the Dcn artifact loaded on the CPU
                            gives logits within 1e-4 of the card's;
 20. sq_search              benchmarks/bench_quantized_search.py's own
                            configuration: 10,000,000 x 128 items (a
                            1024-cluster Gaussian mixture, seed 0), 2048
                            queries (corpus rows + 0.15 noise, seed 7), k 100,
                            ip, through EncoderSearcher (array mode) with
                            index_param "Flat" (the ground truth), "SQ8" and
                            "SQbf16" (SqSearcher's defaults, so the
                            hierarchical tournament runs): the uint8 form of
                            grouped_score_max launched once per query block
                            for SQ8, the bf16 form for SQbf16 (each counted
                            on its own search), the f32 form for Flat; for 256 queries each top-100 against a
                            plain f64 scan on the card (Flat: over the
                            corpus; SQ: the tournament's function, the 100
                            best groups by bf16(q ⊙ scale)·codes, their items
                            rescored by q·x̂): scores within SEARCH_RTOL of
                            their magnitude, and an id in one top-100 but not
                            the other only at the boundary (its score, or its
                            group's maximum, within that tolerance of the
                            100th); build s, search ms, qps and recall@100
                            against Flat;
 21. ann                    the first 1,048,576 rows (the same generator's
                            first chunk, queries drawn as the bench draws
                            them at that size) through index_factory's
                            "IVF4096" (nprobe 32), "PQ16" and "IVF4096,PQ16"
                            (nprobe 32): recall@100 against Flat, build s,
                            search ms; IVF at nprobe = nlist and IVF-PQ at
                            full probe against plain f64 scans of what they
                            score (the vectors; the bf16 lookup tables plus
                            q·c, the overflow pool decoded in f32), PQ
                            against a plain scan of its bf16 decode, for 256
                            queries with the same rules;
 22. host_tier              the sq_search corpus and queries streamed from
                            pinned host memory in blocks of 1,048,576 rows
                            through EncoderSearcher with "HostFlat",
                            "HostSQbf16" and "HostSQ8": kernel 5's f32, bf16
                            and uint8 forms launched 10 times a search (10
                            blocks x 1 query block); HostFlat's top-100
                            against the f64 scan (check_topk), the quantized
                            forms' against their own function in f64 (per
                            block the 100 best groups of bf16(q ⊙ scale)·codes
                            rescored by q·x̂, merged) and against the resident
                            SQ8 / SQbf16 (equal codes; a differing id no worse
                            than the other's 100th); peak device memory of a
                            search below two block buffers, a block's group
                            maxima and the tournament's rows (for HostFlat
                            below the 5.12 GB corpus); build s, search ms,
                            qps, recall@100 against HostFlat, bytes streamed,
                            streamed GB/s beside a pinned copy of one block,
                            the copy-only stream, one block's scan and kernel
                            5 alone (busy share, overlap); then
                            "HostIVF4096,SQ8" (query_block 64) at nprobe 8
                            and 32 on 512 queries: kernel 5 once a batch, ms
                            and rows shipped a batch, recall@100;
 23. parallel               the parallel layer in a world of one over NCCL
                            (real process groups and collectives on the one
                            card the script needs): Dssm at the full width of
                            conf/bench_recall.yaml, 20 eager steps of 1024
                            and an evaluation of 8 batches through
                            Trainer(mesh=make_mesh()).fit with replicated
                            tables (split "auto") and with shard_tables
                            (the dim-64 group row-sharded, the legacy
                            "sparse" update), each under deterministic
                            algorithms beside the single-card fit of the
                            same batches: the loss, val_loss / val_auc and
                            every tensor of the state (weights, buffers,
                            accumulators, Adam moments) within 1e-6
                            relative (per tensor max|a - b| / max|b|;
                            BatchNorm's moments are all-reduced sums over
                            n there); then ShardedSearcher and
                            ShardedSqSearcher (SQbf16, SQ8) from
                            index_factory(..., mesh=) on the sq_search
                            corpus and queries, each top-100 by the
                            sq_search rules (the sharded tournament's k + 1
                            groups in the f64 function) and beside the
                            resident searcher's; kernels 1, 2 or 3, and 5 in
                            all three forms launched on these paths; ms a
                            step (fit's, eager and the single card's graphed
                            fit), idle share and host waits of 10 profiled
                            steps each side, search ms against the
                            resident's in the same call; then both mesh
                            fits in the default dispatch (graphed stacks of
                            8: the NCCL collectives captured with the
                            step; graphs replayed), the replicated one held
                            against the single card's graphed fit by the
                            same rule, ms a step;
 24. cascade                the recall -> rank cascade of
                            examples/cascade_demo_torch.py (run_cascade) at
                            the full width of conf/bench_recall.yaml: Dssm
                            (towers 512-256-128, the dim-64 bf16 group of
                            6,020,008 rows, random weights from seed 0) fits
                            one epoch of 32 batches of 1024 from
                            generate_records (graphed, split "auto"),
                            predicts 1,048,576 synthetic rows (more while
                            the positives' distinct items number below
                            262,144), FlatSearcher(metric="cos") over the
                            de-duplicated positive item vectors (at least
                            262,144: the tournament, kernel 5's f32 form)
                            returns the top 50 of every positive query;
                            Cold (its own hidden 128-64) fits the same
                            records and scores the same rows, and its per-item prior re-orders the
                            candidates: 256 queries' top-50s against a plain
                            f64 scan (check_topk), the re-ranked hit@50
                            equal to stage-1's, finite losses, kernels 1-4
                            launched in the fits, gather_rows in each fit
                            and predict, kernel 5's f32 form (not its bf16
                            or uint8 forms) in the search; seconds and ms of
                            each stage;
 25. encode                 BERT-Base (google-research/bert's bert_config.json,
                            vocab 21,128 as the Chinese release) written as
                            random HF-named pytorch_model.bin, bert_config.json
                            and a generated vocab.txt, loaded by
                            TextEncoderService.from_pretrained (max_len 64,
                            batch 256, pooling cls, whitening, f32 with
                            allow_tf32 off); encode 16,384 generated texts
                            (5-64 tokens, some truncated): vectors finite and
                            unit-norm, the cache returns the same rows,
                            flash_attention launched 12 x the batches; the
                            model's vectors of 8 texts on the card against
                            the same files loaded on the CPU (the port's
                            plain path) within 1e-4 absolute (f32 sums of up
                            to 3072 terms in another order through 12
                            layers, vectors of LayerNorm scale ~1);
 26. serve                  EncodeServer + make_server on 127.0.0.1:0 with
                            that service: /health, concurrent and single
                            /encode requests of new texts through
                            RemoteEncoderClient (no local fallback), encoded
                            on the card (flash_attention launched); the
                            served vectors bitwise equal to a direct encode
                            of the same texts by the service (the JSON round
                            trip of f32 is exact, and each request gets its
                            own rows);
 27. text_search            EncoderSearcher(items=the 16,384 encoded vectors,
                            index_param="SQ8", measurement="cos") searched
                            with the service's own encode of the same texts:
                            item i in the top-10 of query i for every i (an
                            item-block scan below _HIER_MIN_ITEMS, as the JAX
                            package runs it at this size);
 28. cli                    cli/evaluate and cli/predict on a few thousand
                            conf/demo_recall.yaml records written by the
                            port, the second with weights carried through an
                            interop .npz; then cli/train --train_mode test
                            and cli/predict on the checkpoint it saved;
                            cli/train --monitor val_auc, cli/evaluate (auc)
                            and cli/predict on conf/demo_ranking.yaml
                            records (Dnn; then cli/export on its
                            checkpoint and cli/serve --model, whose /predict
                            on the first rows equals cli/predict's scores
                            within 1e-5), on conf/demo_din.yaml records
                            (Din) and on conf/demo_text_recall.yaml records
                            (SiameseEncoder: recall@K from cli/train and
                            cli/evaluate, cli/predict's vectors equal to the
                            trained model's); cli/encode at its own widths
                            (--model_dim 256
                            --num_layers 4 --whitening) with --weights saved
                            by TextEncoderService.save: equal to that
                            service's encode within 1e-6 (the same batches;
                            the whitening read back from its file);
 29. times                  median of >= 20 CUDA-event timings of each kernel,
                            its plain version and one PyTorch library call
                            where one computes the same function, at the
                            phase 2-7 shapes and kernels 1-4 also at the
                            bench_ranking shape (gather_rows at every phase-2
                            shape, each also as the mean of 20 calls between
                            two events, beside its bound, its share of the
                            bound, index_select and its launches at that row
                            width; the uint8 form on phase 3's
                            SQ8 codes, the bf16 form on its bf16 corpus),
                            beside the least time the card could take (the
                            bf16 and uint8 forms at the bf16 tensor-core
                            rate: their products are bf16 x bf16); encode
                            ms per batch of 256, texts/s
                            and the device's idle share (torch.profiler),
                            and /encode request latency; the timing's own
                            floor (two events alone, an empty kernel);
                            flash_attention at TabTransformer's shape beside
                            its bound and SDPA, and its backward there (alone
                            and forward + backward, beside autograd through
                            the plain version and through SDPA); the same
                            rows at text_recall's [128, 12, 64, 64] with its
                            batch's trailing-pad key masks; kernel 6's
                            bounds both dense (every key) and over the keys
                            the mask keeps (the kernels line's).

Then the kernels' JSON line (each kernel's launches on its main path, and
`launches_by_path` over every path whose counts were reset just before it
and read just after: slice, train, ranking, train_options
(the training runs only), long_runs (runs A, B and B resumed),
dispatch (every run of the phase, eager and graphed),
attention_ranking, text_recall, simbert (every seq2seq pass of the phase),
export_serve (kernels 1 and 6 in the loaded programs), sq_search,
sq_search_bf16, host_tier (the counted search of each streamed form,
summed), parallel (both mesh fits and the three sharded searches),
cascade (both fits, both predicts and the search), encode), the card's name and power limit, and the last
line {"ok": true, "device": {...}}. With no CUDA device it exits non-zero and
prints no result. `--cpu-rehearsal` runs every phase at toy sizes on the CPU
through the plain versions (no times, no result, exit code 3).
"""
from __future__ import annotations

import argparse
import copy
import gc
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH_CONF = os.path.join(ROOT, "conf", "bench_recall.yaml")
DEMO_CONF = os.path.join(ROOT, "conf", "demo_recall.yaml")
RANK_CONF = os.path.join(ROOT, "conf", "bench_ranking.yaml")
DEMO_RANK_CONF = os.path.join(ROOT, "conf", "demo_ranking.yaml")
DEMO_DIN_CONF = os.path.join(ROOT, "conf", "demo_din.yaml")
TEXT_CONF = os.path.join(ROOT, "conf", "demo_text_recall.yaml")
TAB_CLASS = "recommendflow_tpu.models.ranking.tabtransformer.TabTransformer"
# the ranking models of the zoo phase, at their demo config's widths:
# name -> (class path, model kwargs, config)
ZOO = {"DeepFm": ("recommendflow_tpu.models.ranking.deepfm.DeepFm", {},
                  DEMO_RANK_CONF),
       "XDeepFm": ("recommendflow_tpu.models.ranking.deepfm.XDeepFm", {},
                   DEMO_RANK_CONF),
       "Cold": ("recommendflow_tpu.models.preranking.cold.Cold", {},
                DEMO_RANK_CONF),
       "Mmoe": ("recommendflow_tpu.models.ranking.mmoe.Mmoe", {},
                DEMO_RANK_CONF),
       "Essm": ("recommendflow_tpu.models.ranking.essm.Essm", {},
                DEMO_RANK_CONF),
       "Escm2-dr": ("recommendflow_tpu.models.reranking.escm2.Escm2",
                    {"counterfactual": "dr"}, DEMO_RANK_CONF),
       "Escm2-ips": ("recommendflow_tpu.models.reranking.escm2.Escm2",
                     {"counterfactual": "ips"}, DEMO_RANK_CONF),
       "Din": ("recommendflow_tpu.models.ranking.din.Din", {}, DEMO_DIN_CONF),
       "TabTransformer": (TAB_CLASS, {}, DEMO_RANK_CONF),
       "Esim": ("recommendflow_tpu.models.ranking.esim.Esim", {},
                DEMO_RANK_CONF)}
# the zoo models that take the gradient check, and those that run kernel 6
GRAD_CHECKED = ("Din", "TabTransformer", "Esim")
ATTENTION_ZOO = ("TabTransformer", "Esim")
MATCHING = "recommendflow_tpu.models.matching"
# the matching models of the matching_zoo phase: name -> (class path, model
# kwargs, config ("image": IMAGE_YAML), Networks overrides, the kernels its
# three steps must launch, whether it takes the gradient check)
TABLE_KERNELS = ("gather_rows", "scatter_add_rows", "rowwise_adagrad_update")
# combine_row_grads' tables, (ids a step, stored width, stored rows): Dssm's
# two at conf/bench_recall.yaml's widths (batch 1024), Dcn/Criteo's 23
# (portbench/configs/dcn_criteo.json's fields grouped by dim, batch 512),
# and one table whose Zipf hot row takes over 10,000 ids
COMBINE_LAYOUTS = {
    "dssm_recall": [(2048, 256, 256), (87040, 256, 1505024)],
    "dcn_criteo": [(1024, 256, 1), (512, 11, 10), (1024, 12, 33),
                   (512, 13, 24), (512, 14, 27), (512, 19, 105),
                   (512, 25, 305), (512, 29, 583), (512, 30, 633),
                   (512, 37, 1460), (512, 41, 2173), (512, 45, 3194),
                   (1024, 52, 11335), (512, 63, 12517), (512, 66, 14992),
                   (512, 105, 93145), (512, 117, 142572), (512, 139, 286181),
                   (512, 231, 2202608), (512, 290, 5461306),
                   (512, 309, 7046547), (512, 323, 8351593),
                   (512, 339, 10131227)],
    "hot_run": [(60000, 256, 1505024)]}
MATCHING_ZOO = {
    "Mobius": (f"{MATCHING}.mobius.Mobius", {}, DEMO_CONF, {},
               TABLE_KERNELS + ("sparse_adagrad_apply",), False),
    "Pdm": (f"{MATCHING}.pdm.Pdm", {}, DEMO_CONF, {},
            TABLE_KERNELS + ("flash_attention",), True),
    "DssmEncoder": (f"{MATCHING}.dssm_encoder.DssmEncoder", {}, TEXT_CONF, {},
                    ("flash_attention",), True),
    "Que2Search": (f"{MATCHING}.que2search.Que2Search", {}, TEXT_CONF, {},
                   TABLE_KERNELS + ("flash_attention",), True),
    # on demo_recall both towers carry sparse features: each tower's embed
    # pass builds its own dense table gradient (two scatter passes a step)
    "Que2Search-recall": (f"{MATCHING}.que2search.Que2Search", {}, DEMO_CONF,
                          {}, TABLE_KERNELS, False),
    "Dssm-image": (f"{MATCHING}.dssm.Dssm", {}, "image", {},
                   TABLE_KERNELS + ("sparse_adagrad_apply",), False),
    "Dssm-vit": (f"{MATCHING}.dssm.Dssm", {}, "image",
                 {"image_encoder": "vit"},
                 TABLE_KERNELS + ("sparse_adagrad_apply", "flash_attention"),
                 True)}
# tests/test_image.py's layout: an image slot of 32x32 pixels (8x8 patches)
IMAGE_YAML = """Features:
  feature_group:
    user_id: [user_id]
    item_id: [item_id]
    item_img: [item_img]
  feature_fields: [group, type, tower, deal, vocab, embedding_dim, pooling, working]
  features:
    user_id,str,user,hashing,2000,16,sum,true
    item_id,str,ad,hashing,2000,16,sum,true
    item_img,str,ad,image,null,24,null,true
    label,float,label,numeric,null,-1,null,true
Variables:
  seeds: [2022, 2023]
  max_len_map:
    item_img: 32
Networks:
  class: recommendflow_tpu.models.matching.dssm.Dssm
  loss: recommendflow_tpu.losses.match.batch_neg_sample_scaled_multi_class_ce_loss
  embedding_dim: 32
  tower_units: [32]
Task:
  task: test_image
Train:
  data: /tmp/unused
  epoch: 1
  batch_size: 16
"""
# text_recall: both texts' max_len, and the card-vs-CPU tolerance of its
# vectors (f32 sums of up to 3072 terms through 12 layers, as encode's)
TEXT_LEN = 64
TEXT_CPU_TOL = 1e-4
TEXT_LR = 2e-5
PHASES = ("build", "gather_rows", "grouped_score_max", "scatter_add_rows",
          "rowwise_adagrad_update", "sparse_adagrad_apply",
          "combine_row_grads", "flash_attention",
          "slice", "train", "ranking", "train_options", "long_runs",
          "dispatch", "ranking_zoo",
          "attention_ranking", "text_recall", "simbert", "matching_zoo",
          "export_serve", "sq_search", "ann", "host_tier", "parallel",
          "cascade", "encode", "serve", "text_search", "cli", "times")
TABLE_PHASES = ("scatter_add_rows", "rowwise_adagrad_update",
                "sparse_adagrad_apply")
ENCODER_PHASES = ("flash_attention", "encode", "serve", "text_search", "cli",
                  "times")
QUANT_PHASES = ("sq_search", "ann", "host_tier")

# published peaks (NVIDIA data sheets, dense, at the full power limit):
# memory bytes/s, FP32 flop/s outside the tensor cores, bf16 tensor-core
# flop/s
PEAKS = {"PCIe": (2.0e12, 51.2e12, 756e12), "NVL": (3.9e12, 60.0e12, 835e12),
         "SXM": (3.35e12, 67.0e12, 989e12)}

KERNEL_META = {
    "gather_rows": dict(
        route="cuda", source="recommendflow_tpu_torch/csrc/embedding_bag.cu",
        replaces="recommendflow_tpu/ops/pallas/embedding_bag.py:112"),
    "grouped_score_max": dict(
        route="cuda", source="recommendflow_tpu_torch/csrc/grouped_topk.cu",
        replaces="recommendflow_tpu/ops/pallas/grouped_topk.py:67"),
    "scatter_add_rows": dict(
        route="cuda", source="recommendflow_tpu_torch/csrc/embedding_bag.cu",
        replaces="recommendflow_tpu/ops/pallas/embedding_bag.py:229"),
    "rowwise_adagrad_update": dict(
        route="cuda", source="recommendflow_tpu_torch/csrc/table_update.cu",
        replaces="recommendflow_tpu/ops/pallas/table_update.py:56"),
    "sparse_adagrad_apply": dict(
        route="cuda", source="recommendflow_tpu_torch/csrc/sparse_apply.cu",
        replaces="recommendflow_tpu/ops/pallas/sparse_apply.py:92"),
    "combine_row_grads": dict(
        route="cuda", source="recommendflow_tpu_torch/csrc/row_grad_combine.cu",
        replaces="none (XLA's sort and segment sum in the JAX trainer)"),
    "flash_attention": dict(
        route="cuda", source="recommendflow_tpu_torch/csrc/flash_attention.cu",
        replaces="recommendflow_tpu/ops/pallas/flash_attention.py:73"),
    "grouped_score_max_uint8": dict(
        route="cuda", source="recommendflow_tpu_torch/csrc/grouped_topk.cu",
        replaces="recommendflow_tpu/ops/pallas/grouped_topk.py:50-56"),
    "grouped_score_max_bf16": dict(
        route="cuda", source="recommendflow_tpu_torch/csrc/grouped_topk.cu",
        replaces="recommendflow_tpu/ops/pallas/grouped_topk.py:84-87"),
}
# the path each kernel's launches are counted on
KERNEL_PATH = {"gather_rows": "slice", "grouped_score_max": "slice",
               "scatter_add_rows": "train", "rowwise_adagrad_update": "train",
               "sparse_adagrad_apply": "train", "combine_row_grads": "train",
               "flash_attention": "encode",
               "grouped_score_max_uint8": "sq_search",
               "grouped_score_max_bf16": "sq_search_bf16"}
FA_F32_TOL = 1e-5
FA_BF16_TOL = 2.0 ** -6        # times max|v|
# kernel 6's backward against autograd through the plain version: times
# max(1, max|grad|)
FA_GRAD_TOL = 1e-5
# a model's gradients on the card against the CPU (dropout 0): each dense
# parameter within GRAD_TOL of its largest magnitude; an attention key
# bias (exact gradient 0) below K_BIAS_TOL of the model's largest gradient
GRAD_TOL = 1e-4
K_BIAS_TOL = 1e-5
# past GRAD_TOL a leaf's card gradient must lie no farther from the f64
# gradient than this many times the CPU f32's own distance from it. Sound
# runs read up to 2.7 (DssmEncoder after three steps at lr 1e-3, where the
# reading moves by 1.5x between identical runs); a card copy with kernel 6
# dropping each row's last valid key reads above 10,000
GRAD_CPU_FACTOR = 8.0
ENCODE_CPU_TOL = 1e-4
# ranking logits and outputs on the card against the CPU (f32 products, TF32
# off, summed in another order): Dcn's logits at bench_ranking width (first
# layer 1677 wide), the zoo's outputs at demo width
RANK_CPU_TOL = 1e-4
ZOO_CPU_TOL = 1e-5
CLI_TOL = 1e-6
# a bf16 compute_dtype Dssm against the f32 one with the same weights: each
# of its 3 layers rounds ~4 times (2^-9 relative each), and an L2-normalised
# row moves by at most ~2 * 3 * 4 * 2^-9 = 0.047 (tests/test_torch_mlp_dtype.py)
BF16_ROW_TOL = 2.0 ** -4
LR = 0.03   # the table learning rate of the bench config (default_table_lr)
# simbert: Adam at BERT's pre-training peak rate (Devlin et al. 2019,
# appendix A.2: 1e-4) on one repeated batch; its loss and both parts on the
# card against the CPU (scalars from f32 sums in another order through 12
# layers and a 21,128-way log-softmax)
SIMBERT_LR = 1e-4
SIMBERT_LOSS_RTOL = 1e-4
# f32 search scores against an f64 scan: sums of 128 products in f32 carry
# up to ~1e-6 of their magnitude (8.5e-7 measured on the quantized-search
# corpus, scores 90-200); within 4e-6 of max(1, |score|) is a match
SEARCH_RTOL = 4e-6
# the parallel phase: a world-1 mesh step against the single-card step.
# The collectives are identities there; BatchNorm takes its moments from
# all-reduced sums (sum / n, where the single card takes torch.mean), so
# the loss, the evaluation and every tensor of the state after the steps
# are held within this relative error (per tensor: max|a - b| / max|b|)
PARALLEL_RTOL = 1e-6
SCAN_REPS = 5   # timed calls of the ~56 ms plain and library scans
K = 100


def make_corpus(np, n: int, dim: int, seed: int = 0):
    """benchmarks/bench_quantized_search.py's clustered corpus: a 1024-centre
    Gaussian mixture (centres N(0, 1), noise 0.35), made in 1M-row chunks."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((1024, dim), np.float32)
    out = np.empty((n, dim), np.float32)
    for s in range(0, n, 1 << 20):
        e = min(n, s + (1 << 20))
        cid = rng.integers(0, len(centers), e - s)
        out[s:e] = centers[cid] + 0.35 * rng.standard_normal(
            (e - s, dim), np.float32)
    return out


def bench_queries(np, corpus, q: int):
    """The bench's queries: corpus rows drawn by default_rng(7), plus 0.15
    Gaussian noise."""
    rng = np.random.default_rng(7)
    qidx = rng.integers(0, len(corpus), q)
    return corpus[qidx] + 0.15 * rng.standard_normal(
        (q, corpus.shape[1]), np.float32)


def recall_at_k(got, gt) -> float:
    k = gt.shape[1]
    return sum(len(set(got[i, :k]) & set(gt[i])) for i in range(len(gt))) \
        / (len(gt) * k)


def merge_topk(torch, best, scores, start: int, k: int):
    """Fold one item block's scores [Q, b] (item ids from `start`) into the
    running (top scores, ids)."""
    s, i = torch.topk(scores, min(k, scores.shape[1]), dim=1)
    i = i + start
    if best is not None:
        s, p = torch.topk(torch.cat([best[0], s], 1), k, dim=1)
        i = torch.gather(torch.cat([best[1], i], 1), 1, p)
    return s, i


def check_topk(torch, what, got_s, got_i, ref_s, ref_i, score_of, group_near=None):
    """A searcher's top-k (f32) against a plain f64 reference: each returned
    score the true score of its id (score_of(ids [Q, n]) -> f64) within
    SEARCH_RTOL of its magnitude; an id in one top-k but not the other only
    at the boundary (its score within the tolerance of the k-th, or, with
    group_near(row, ids), its group's maximum within the tolerance of the
    k-th group's: the groups tie); and, in rows with no such swap, the
    scores within the tolerance of the reference's, position by position."""
    got_s = torch.as_tensor(got_s, dtype=torch.float64, device=ref_s.device)
    got_i = torch.as_tensor(got_i, device=ref_i.device).long()
    tol = SEARCH_RTOL * ref_s.abs().clamp(min=1.0)
    own_err = float(((got_s - score_of(got_i)).abs() / tol).max()) * SEARCH_RTOL
    kth = ref_s[:, -1]
    gi, ri = got_i.cpu().numpy(), ref_i.cpu().numpy()
    swapped = torch.zeros(len(gi), dtype=torch.bool, device=ref_s.device)
    differ = 0
    for r in range(len(gi)):
        odd = set(gi[r].tolist()) ^ set(ri[r].tolist())
        if not odd:
            continue
        ids = torch.tensor(sorted(odd), device=ref_s.device)
        s = score_of(ids[None, :].expand(len(gi), -1))[r]
        near = (s - kth[r]).abs() <= tol[r, -1]
        if group_near is not None:
            near |= group_near(r, ids)
        require(bool(near.all()), f"{what}: row {r} ids {sorted(odd)[:5]} "
                f"differ away from the boundary")
        swapped[r] = True
        differ += len(odd) // 2
    keep = ~swapped
    score_err = float(((got_s - ref_s).abs() / tol)[keep].max()) * SEARCH_RTOL \
        if bool(keep.any()) else 0.0
    require(score_err <= SEARCH_RTOL and own_err <= SEARCH_RTOL,
            f"{what}: top-{ref_s.shape[1]} scores off by {score_err} / "
            f"{own_err} (relative) > {SEARCH_RTOL}")
    return {"score_rel_err": score_err, "own_score_rel_err": own_err,
            "boundary_swaps": differ, "rows_with_swaps": int(swapped.sum()),
            "index_match": float((gi == ri).mean())}


def text_conf_file(directory: str) -> str:
    """conf/demo_text_recall.yaml with its vocabulary path made absolute (the
    config names it relative to the repository's root), written into
    `directory`: the script then runs from any directory."""
    with open(TEXT_CONF) as f:
        text = f.read()
    path = os.path.join(directory, os.path.basename(TEXT_CONF))
    with open(path, "w") as f:
        f.write(text.replace("conf/demo_vocab.txt",
                             os.path.join(ROOT, "conf", "demo_vocab.txt")))
    return path


GEMM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def op_classes(prof, vocab: int, length: int) -> dict:
    """Device ms of a profiled window by op class, from each host op's own
    kernels (self device time) and its input shapes: the tied LM head's
    GEMMs (a vocab-wide operand), the other vocab-wide ops (the head's
    log-softmax and gather, the tied table's gradient sum and Adam), the
    vanilla attention (batched GEMMs, and the softmax and masking over
    [.., L, L] scores), the encoder's other GEMMs, and the rest."""
    import torch
    out = {"lm_head_gemm": 0.0, "vocab_wide_other": 0.0,
           "attention_gemm": 0.0, "attention_other": 0.0,
           "encoder_gemm": 0.0, "other": 0.0}
    for a in prof.key_averages(group_by_input_shape=True):
        if a.device_type != torch.autograd.DeviceType.CPU:
            continue              # kernels: counted under the op that ran them
        t = getattr(a, "self_device_time_total", None)
        if t is None:
            t = getattr(a, "self_cuda_time_total", 0.0)
        if not t:
            continue
        shapes = [tuple(x) for x in (a.input_shapes or []) if x]
        gemm = a.key in GEMM_OPS
        if any(vocab in x for x in shapes):
            key = "lm_head_gemm" if gemm else "vocab_wide_other"
        elif a.key in ("aten::bmm", "aten::baddbmm"):
            key = "attention_gemm"
        elif any(len(x) == 4 and x[-2:] == (length, length) for x in shapes):
            key = "attention_other"
        elif gemm:
            key = "encoder_gemm"
        else:
            key = "other"
        out[key] += t / 1e3
    return out


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def ulps(torch, a, b) -> float:
    """Largest |a - b| of two f32 or bf16 tensors in units of their type's
    spacing at max(|a|, |b|): a difference of one rounding is <= 1 however
    close to zero the values are."""
    if a.numel() == 0:
        return 0.0
    bits = 7 if a.dtype == torch.bfloat16 else 23
    a32, b32 = a.float(), b.float()
    mag = torch.maximum(a32.abs(), b32.abs()).clamp(min=2.0 ** -126)
    spacing = torch.exp2(torch.floor(torch.log2(mag)) - bits)
    return float(((a32 - b32).abs() / spacing).max())


def rel_err(x, ref) -> float:
    return float(((x - ref).abs() / ref.abs().clamp(min=1e-30)).max()) \
        if x.numel() else 0.0


def check_table_update(torch, what, p, acc, p_ref, acc_ref, p0, acc0, touched):
    """A table update against its reference: p bitwise, acc within rtol
    1e-6, untouched rows (touched: bool [R]) bitwise as they were."""
    err = {"p_ulps": ulps(torch, p, p_ref),
           "p_max_abs_err": float((p.float() - p_ref.float()).abs().max()),
           "acc_rel_err": rel_err(acc, acc_ref),
           "touched_rows": int(touched.sum())}
    keep = ~touched
    same = bool(torch.equal(p[keep].view(torch.int16 if p.dtype == torch.bfloat16
                                         else torch.int32),
                            p0[keep].view(torch.int16 if p.dtype == torch.bfloat16
                                          else torch.int32))
                and torch.equal(acc[keep], acc0[keep]))
    err["untouched_bitwise"] = same
    require(err["p_ulps"] == 0, f"{what}: p differs by {err['p_ulps']} ulps")
    require(err["acc_rel_err"] <= 1e-6, f"{what}: acc rel err "
            f"{err['acc_rel_err']}")
    require(same, f"{what}: an untouched row changed")
    return err


def mismatches(torch, a, b, path="state"):
    """Where two state_to_host trees differ: [(path, max |a - b| or None)],
    empty when every tensor is equal bit for bit."""
    bad = []
    if isinstance(a, torch.Tensor):
        if not (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b)):
            bad.append((path, float((a.double() - b.double()).abs().max())
                        if a.shape == b.shape else None))
    elif isinstance(a, dict):
        if sorted(a, key=str) != sorted(b, key=str):
            return [(path + " (keys)", None)]
        for k in a:
            bad += mismatches(torch, a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (u, v) in enumerate(zip(a, b)):
            bad += mismatches(torch, u, v, f"{path}/{i}")
    elif a != b:
        bad.append((path, None))
    return bad


def card_peaks(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return PEAKS[key]
    return PEAKS["SXM"]


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60
    ).stdout.strip().splitlines()[0]


class Timer:
    """Device time of single calls from CUDA events. The calls are queued
    behind a sleep kernel, so host launch overhead does not enter the
    measured gaps."""

    def __init__(self, torch, reps: int):
        self.torch, self.reps = torch, reps

    def median_ms(self, fn, reps: int = 0) -> float:
        """The median of `reps` calls (default: the timer's own), each
        between two events."""
        torch = self.torch
        reps = reps or self.reps
        fn(0)                                   # warm-up (and lazy load)
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
        torch.cuda._sleep(200_000_000)
        ev[0].record()
        for i in range(reps):
            fn(i)
            ev[i + 1].record()
        torch.cuda.synchronize()
        t = sorted(ev[i].elapsed_time(ev[i + 1]) for i in range(reps))
        return t[len(t) // 2]

    def batched_ms(self, fn) -> float:
        """The mean of the timer's reps calls between two events: no event
        recorded between the calls (two events alone take ~3 us on the
        H100)."""
        torch = self.torch
        fn(0)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(200_000_000)
        start.record()
        for i in range(self.reps):
            fn(i)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / self.reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma list of {PHASES} (default: all)")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="toy sizes on the CPU through the plain versions")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    require(all(p in PHASES for p in phases), f"unknown phase in {phases}")
    rehearse = args.cpu_rehearsal

    import numpy as np
    import torch

    if not rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.schema import compile_schema
    from recommendflow_tpu_torch.data.synthetic import (generate_records,
                                                        synthetic_batch)
    from recommendflow_tpu_torch.interop import (jax_from_variables,
                                                 save_variables_npz)
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.ops.cuda import KERNELS, _build
    from recommendflow_tpu_torch.ops.cuda import embedding_bag as k_rows
    from recommendflow_tpu_torch.ops.cuda import grouped_topk as k_scan
    from recommendflow_tpu_torch.ops.cuda import sparse_apply as k_sparse
    from recommendflow_tpu_torch.ops.cuda import table_update as k_dense
    from recommendflow_tpu_torch.ops.cuda import flash_attention as k_fa
    from recommendflow_tpu_torch.ops.cuda import row_grad_combine as k_comb
    from recommendflow_tpu_torch.ops.attention import split_heads
    from recommendflow_tpu_torch.encoder import TextEncoderService, Tokenizer
    from recommendflow_tpu_torch.encoder import synthetic as enc_syn
    from recommendflow_tpu_torch.ops.embedding import (fused_group_ids,
                                                       physical_ids)
    from recommendflow_tpu_torch.retrieval.eval import (
        batch_compute_recall_score, build_eval_corpus)
    from recommendflow_tpu_torch.retrieval.flat import FlatSearcher
    from recommendflow_tpu_torch.retrieval import EncoderSearcher, _kernels
    from recommendflow_tpu_torch.train.optimizers import (init_accumulator,
                                                          split_table_update)
    from recommendflow_tpu_torch.train.trainer import (Trainer, plan_strategy,
                                                       predict, split_costs,
                                                       table_params, to_device)
    from recommendflow_tpu_torch.utils.trace import parse_trace

    dev = torch.device("cpu" if rehearse else "cuda:0")
    # toy sizes for the rehearsal; full sizes on the card
    S = dict(batch=1024, n_batches=1024, q=4096, n_pad=1 << 20, d=128,
             search_q=4096, cli_rows=4000, reps=20, wide_q=2048,
             wide_n=1 << 16) if not rehearse else \
        dict(batch=64, n_batches=8, q=64, n_pad=1 << 13, d=128, search_q=64,
             cli_rows=400, reps=2, wide_q=16, wide_n=1024)
    # the encoder path: BERT-Base on the card, a two-layer toy of it here
    E = dict(config=enc_syn.BERT_BASE, texts=16384, batch=256, serve_clients=8,
             serve_texts=32, latency_reps=10, cli_texts=2048) if not rehearse \
        else dict(config=dict(enc_syn.BERT_BASE, hidden_size=64,
                              num_hidden_layers=2, num_attention_heads=4,
                              intermediate_size=128),
                  texts=512, batch=64, serve_clients=4, serve_texts=8,
                  latency_reps=2, cli_texts=128)
    sync = torch.cuda.synchronize if not rehearse else (lambda: None)
    card = nvidia_smi() if not rehearse else "cpu rehearsal"
    kind = torch.cuda.get_device_name(0) if not rehearse else "cpu"
    bw, flops, bf16_tc = card_peaks(kind)
    gen = torch.Generator(device=dev).manual_seed(0)
    t_start = time.perf_counter()
    # cli/train installs its preemption handler for the rest of the process
    # (as the JAX CLI does); the script puts these back after each caller
    signals = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}

    def own_signals():
        for s, h in signals.items():
            signal.signal(s, h)

    def log(phase, **kw):
        emit({"phase": phase, **kw, "t": round(time.perf_counter() - t_start, 3)})

    # ---------------------------------------------------------- 1. build
    if "build" in phases and not rehearse:
        t0 = time.perf_counter()
        secs = _build.build(KERNELS)
        ptxas = {n: [ln.strip() for ln in _build.BUILD_LOGS.get(n, "").splitlines()
                     if "Used" in ln or "spill" in ln] for n in KERNELS}
        # the bf16 and uint8 forms of grouped_score_max run on tensor cores:
        # wgmma is HGMMA in the SASS (cuobjdump ships with nvcc)
        cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                                 "cuobjdump")
        require(os.path.exists(cuobjdump), f"no cuobjdump beside nvcc "
                f"({cuobjdump}): the HGMMA check cannot run")
        dump = subprocess.run(
            [cuobjdump, "-sass", _build.library_path("grouped_topk")],
            check=True, capture_output=True, text=True, timeout=300).stdout
        hgmma = [ln.strip() for ln in dump.splitlines() if "HGMMA" in ln]
        require(bool(hgmma), "grouped_topk: no HGMMA (wgmma) in its SASS")
        sass = {"grouped_topk_hgmma": len(hgmma), "first": hgmma[0]}
        log("build", wall_s=time.perf_counter() - t0, per_kernel_s=secs,
            ptxas=ptxas, sass=sass)

    # --------------------------------------------- shared inputs (2-6, 14)
    bench_conf = Configuration(BENCH_CONF)
    schema = compile_schema(bench_conf.features)
    group64 = schema.groups[64]
    rows64 = group64.total_rows if not rehearse else 4096
    rows64 = -(-rows64 // 1024) * 1024
    table64 = torch.randn((rows64, 64), generator=gen, device=dev
                          ).to(torch.bfloat16)
    # the same table in its stored layout [R/4, 256]: 512-byte rows
    stored = table64.view(-1, 256)
    R = stored.shape[0]

    def ids_for(seed, sch=schema, dim=64, rows=rows64, batch=S["batch"],
                zipf=0.0):
        """One synthetic batch's logical ids of the dim group (fused)."""
        b = synthetic_batch(sch, batch, seed=seed, zipf=zipf)
        ids = fused_group_ids(sch, {k: torch.from_numpy(v) for k, v in
                                    b.items()})[dim].reshape(-1)
        return (ids % rows).to(torch.int32).to(dev)

    def update_inputs(seed, **shape):
        """One batch's table-update inputs (at the main-path shape unless
        `shape` gives ids_for another): the stored rows its ids touch, f32
        row gradients, the sorted duplicate sums (uid, summed, n_valid) and
        a bool [R] of the touched rows."""
        per = 256 // shape.get("dim", 64)
        n_stored = shape.get("rows", rows64) // per
        sid = ids_for(seed, **shape) // per
        g = torch.randn((sid.numel(), 256), generator=gen, device=dev) * 0.01
        s_, order = torch.sort(sid, stable=True)
        summed, uid, _, n_valid = k_rows.segment_row_grads(s_, g[order],
                                                           num_rows=n_stored)
        touched = torch.zeros(n_stored, dtype=torch.bool, device=dev)
        touched[sid.long()] = True
        return dict(uid=uid, summed=summed, n_valid=n_valid, touched=touched,
                    n_ids=sid.numel())

    # the bench_ranking shape: the dim-32 group of 39,000,052 logical rows
    # stored bf16 as [R/8, 256], batches of 2048
    rk_schema = compile_schema(Configuration(RANK_CONF).features)
    rank = dict(sch=rk_schema, dim=32, batch=2048 if not rehearse else 64,
                rows=-(-rk_schema.groups[32].total_rows // 1024) * 1024
                if not rehearse else 8192)

    def ranking_table():
        return torch.randn((rank["rows"], 32), generator=gen, device=dev
                           ).to(torch.bfloat16)

    def gather_cases(table32, seed, n=1):
        """Kernel 1's shapes on the main paths, each (table, [ids] x n):
        serving (logical rows) and the trainer's split gather (stored rows)
        of both bench tables, and ranking serving on Zipf(1.2) ids."""
        rec = [ids_for(seed + i) for i in range(n)]
        rk = [ids_for(seed + i, **rank) for i in range(n)]
        return {"recall_serving": (table64, rec),
                "recall_split": (stored, [i // 4 for i in rec]),
                "ranking_serving": (table32, rk),
                "ranking_serving_zipf1.2": (table32, [ids_for(
                    seed + 500 + i, zipf=1.2, **rank) for i in range(n)]),
                "ranking_split": (table32.view(-1, 256),
                                  [i // 8 for i in rk])}

    errs = {}
    if "gather_rows" in phases or "times" in phases:
        table32 = ranking_table()
        held = {}
        for name, (table_, (ids_,)) in gather_cases(table32, 10_000).items():
            got = k_rows.gather_rows(table_, ids_)
            ref = k_rows.gather_rows_plain(table_, ids_)
            sync()
            same = bool(torch.equal(got.view(torch.int16),
                                    ref.view(torch.int16)))
            require(same, f"gather_rows differs from its plain version at "
                    f"{name}")
            held[name] = {"table": list(table_.shape), "ids": ids_.numel(),
                          "max_abs_err": float((got.float() - ref.float()
                                                ).abs().max())}
        errs["gather_rows"] = max(h["max_abs_err"] for h in held.values())
        del table32, got, ref
        log("gather_rows", shapes=held, bitwise_equal=True,
            max_abs_err=errs["gather_rows"])

    q = torch.nn.functional.normalize(
        torch.randn((S["q"], S["d"]), generator=gen, device=dev), dim=1)
    corpus = torch.nn.functional.normalize(
        torch.randn((S["n_pad"], S["d"]), generator=gen, device=dev), dim=1)
    num_items = S["n_pad"] - 1000          # a masked, partial tail group
    G = 16
    codes_u = qs_u = None
    if "grouped_score_max" in phases or "times" in phases:
        scale = torch.rand((S["n_pad"], 1), generator=gen, device=dev) + 0.5
        # the uint8 form on the SQ8 codes of the same corpus (SqSearcher's
        # per-dim affine encode), queries q ⊙ scale as SQ8 search hands them
        vmin_u = corpus.amin(0)
        scale_u = (corpus.amax(0) - vmin_u) / 255.0
        codes_u = torch.clamp(torch.round((corpus - vmin_u) / scale_u), 0,
                              255).to(torch.uint8)
        qs_u = q * scale_u
        xsq_u = ((vmin_u + scale_u * codes_u.float()) ** 2).sum(1)
        variants = {
            "f32_ip": (q, corpus, None),
            "bf16_ip": (q, corpus.to(torch.bfloat16), None),
            "f32_l2": (q, corpus * scale, ((corpus * scale) ** 2).sum(1)),
            "u8_ip": (qs_u, codes_u, None),
            "u8_l2": (qs_u, codes_u, xsq_u),
        }
        by_variant = {}
        for name, (qv_, v, sqn) in variants.items():
            got = k_scan.grouped_score_max(qv_, v, sqn, group=G,
                                           num_items=num_items)
            ref = k_scan.grouped_score_max_plain(qv_, v, sqn, group=G,
                                                 num_items=num_items)
            sync()
            require(tuple(got.shape) == (S["q"], S["n_pad"] // G),
                    f"grouped_score_max {name}: shape {tuple(got.shape)}")
            by_variant[name] = float((got - ref).abs().max())
            require(by_variant[name] <= 1e-4, f"grouped_score_max {name}: max "
                    f"abs diff {by_variant[name]} > 1e-4")
            del got, ref
        del variants, scale, xsq_u
        # the tensor-core forms past the resident query tile (D above
        # 256-320 at 256 queries a block): each ring stage carries the query
        # rows' K-block beside the items. Scores of std ~2 keep the f32 sums
        # of 1536 exact products inside the same atol 1e-4.
        wide, wq, wn = {}, S["wide_q"], S["wide_n"]
        for wd in (512, 1536):
            wv = torch.randn((wn, wd), generator=gen, device=dev)
            wc = torch.randint(0, 256, (wn, wd), generator=gen, device=dev,
                               dtype=torch.uint8)
            for name, v in ((f"bf16_d{wd}", wv.to(torch.bfloat16)),
                            (f"u8_d{wd}", wc)):
                wqs = torch.randn((wq, wd), generator=gen, device=dev)
                wqs *= 2.0 / (wd * float(v.float().pow(2).mean())) ** 0.5
                got = k_scan.grouped_score_max(wqs, v, None, group=G,
                                               num_items=wn - 5)
                ref = k_scan.grouped_score_max_plain(wqs, v, None, group=G,
                                                     num_items=wn - 5)
                sync()
                err = float((got - ref).abs().max())
                require(err <= 1e-4, f"grouped_score_max {name}: max abs diff "
                        f"{err} > 1e-4")
                by_variant[name] = err
                # device time of the streamed form beside its bound (not on
                # a main path; the kernels line times the main-path shape)
                wide[name] = {
                    "ms": Timer(torch, 5).median_ms(
                        lambda i: k_scan.launch_grouped_score_max(
                            wqs, v, None, group=G, num_items=wn - 5))
                    if not rehearse else None,
                    "bound_ms": 2.0 * wq * (wn - 5) * wd / bf16_tc * 1e3}
                del got, ref
            del wv, wc
        errs["grouped_score_max"] = max(by_variant["f32_ip"],
                                        by_variant["f32_l2"])
        errs["grouped_score_max_bf16"] = by_variant["bf16_ip"]
        errs["grouped_score_max_uint8"] = max(by_variant["u8_ip"],
                                              by_variant["u8_l2"])
        log("grouped_score_max", q=S["q"], n_pad=S["n_pad"], d=S["d"], group=G,
            num_items=num_items, max_abs_err=by_variant, tolerance=1e-4,
            wide_rows={"q": wq, "n_pad": wn, "times": wide})

    upd = None
    if any(p in phases for p in TABLE_PHASES) or "times" in phases:
        upd = update_inputs(10_001)
        acc0 = torch.rand((R, 1), generator=gen, device=dev) + 0.1
        u, sm, nv, touched = (upd["uid"], upd["summed"], upd["n_valid"],
                              upd["touched"])
        gd = torch.zeros_like(stored)
        gd_ref = torch.zeros_like(stored)
        k_rows.scatter_add_rows(u, sm, gd, nv)
        k_rows.scatter_add_rows_plain(u, sm, gd_ref, nv)
        sync()
        same = bool(torch.equal(gd.view(torch.int16), gd_ref.view(torch.int16)))
        require(same, "scatter_add_rows differs from its plain version")
        errs["scatter_add_rows"] = float((gd.float() - gd_ref.float()).abs().max())
        log("scatter_add_rows", table=list(stored.shape), ids=upd["n_ids"],
            unique_rows=int(nv), bitwise_equal=same,
            max_abs_err=errs["scatter_add_rows"])
        del gd_ref

        p_k, a_k = stored.clone(), acc0.clone()
        p_r, a_r = stored.clone(), acc0.clone()
        k_dense.rowwise_adagrad_update(p_k, a_k, gd, lr=LR)
        k_dense.rowwise_adagrad_update_plain(p_r, a_r, gd, lr=LR)
        sync()
        err = check_table_update(torch, "rowwise_adagrad_update", p_k, a_k,
                                 p_r, a_r, stored, acc0, touched)
        errs["rowwise_adagrad_update"] = err["p_max_abs_err"]
        log("rowwise_adagrad_update", **err)

        p_k.copy_(stored), a_k.copy_(acc0)
        p_r.copy_(stored), a_r.copy_(acc0)
        k_sparse.sparse_adagrad_apply(p_k, a_k, u, sm, nv, lr=LR)
        k_sparse.sparse_adagrad_apply_plain(p_r, a_r, u, sm, nv, lr=LR)
        sync()
        err = check_table_update(torch, "sparse_adagrad_apply", p_k, a_k,
                                 p_r, a_r, stored, acc0, touched)
        errs["sparse_adagrad_apply"] = err["p_max_abs_err"]
        log("sparse_adagrad_apply", **err)
        del p_k, a_k, p_r, a_r

    # ------------------------------------------------ 6b. combine_row_grads
    comb_times = {}
    if "combine_row_grads" in phases:
        crng = np.random.default_rng(12)

        def comb_tables(specs):
            """Zipf(1.2) stored-row ids, the hot row a third into the
            table, and bf16 row gradients: (ids, g, rows) per spec."""
            out = []
            for n, width, rows in specs:
                n = n if not rehearse else max(1, n // 16)
                ids = ((crng.zipf(1.2, n) - 1 + rows // 3) % rows).astype(
                    np.int32)
                g = crng.standard_normal((n, width), dtype=np.float32) * 0.01
                out.append((torch.from_numpy(ids).to(dev),
                            torch.from_numpy(g).to(dev).to(torch.bfloat16),
                            rows))
            return out

        def replay_ms(fn):
            """fn captured into a CUDA graph, one replay's median time."""
            fn()
            sync()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                fn()
            return Timer(torch, 20).median_ms(lambda i: graph.replay())

        for name, specs in COMBINE_LAYOUTS.items():
            tables = comb_tables(specs)
            by = dict(k_comb.combine_row_grads.launches_by_tables)
            got = k_comb.combine_row_grads(tables)
            again = k_comb.combine_row_grads(tables)
            plain = k_comb.combine_row_grads_plain(tables)
            sync()
            grouped = k_comb.combine_row_grads.launches_by_tables.get(
                len(tables), 0) - by.get(len(tables), 0)
            bitwise = all(torch.equal(a, b) for x, y in zip(got, again)
                          for a, b in zip(x, y))
            same_rows = all(torch.equal(x[k], y[k]) for x, y in zip(got, plain)
                            for k in (1, 2, 3))
            err = max(float((x[0] - y[0]).abs().max()) /
                      max(1.0, float(y[0].abs().max()))
                      for x, y in zip(got, plain))
            require(bitwise, f"combine_row_grads ({name}) differs between "
                    f"two calls")
            require(same_rows, f"combine_row_grads ({name}): uid, valid or "
                    f"n_valid differ from the plain version")
            require(err <= 1e-5, f"combine_row_grads ({name}): sums {err} "
                    f"from the plain version")
            require(rehearse or grouped == 2, f"combine_row_grads ({name}): "
                    f"{grouped} grouped calls of {len(tables)} tables, not 2")
            rec = dict(tables=len(tables),
                       ids=sum(int(t[0].numel()) for t in tables),
                       distinct_rows=sum(int(x[3]) for x in got),
                       longest_run=max(int(torch.bincount(t[0].long()).max())
                                       for t in tables),
                       bitwise_across_calls=bitwise, max_rel_err=err,
                       grouped_calls=grouped)
            if not rehearse:
                rec["grouped_replay_ms"] = replay_ms(
                    lambda: k_comb.combine_row_grads(tables))
                rec["per_table_pytorch_replay_ms"] = replay_ms(
                    lambda: k_comb.combine_row_grads_plain(tables))
                comb_times[name] = rec
            log("combine_row_grads", layout=name, **rec)
            del got, again, plain, tables
        errs["combine_row_grads"] = 0.0

    # ----------------------------------------- encoder inputs (7, 23-27)
    cfg = E["config"]
    heads, layers = cfg["num_attention_heads"], cfg["num_hidden_layers"]
    head_dim = cfg["hidden_size"] // heads
    enc_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_bert_")
    bert_files = None
    texts = tokenizer = fa_mask = None
    if any(p in phases for p in ENCODER_PHASES):
        vocab = enc_syn.make_vocab(cfg["vocab_size"], seed=0)
        tokenizer = Tokenizer({t: i for i, t in enumerate(vocab)})
        texts = enc_syn.make_texts(E["texts"], seed=0)
        # the key mask of one batch: [256, 64] from the texts' token counts
        fa_mask = torch.from_numpy(
            tokenizer.encode_batch(texts[:E["batch"]], 64)[0] > 0).to(dev)

    def path_qkv(dtype):
        """q, k, v at the encoder's attention shape, as split_heads hands
        them over: [B, H, L, D] views of [B, L, H*D] projections."""
        return [split_heads(torch.randn(
            (E["batch"], 64, heads * head_dim), generator=gen, device=dev
        ).to(dtype), heads) for _ in range(3)]

    # TabTransformer's attention at bench_ranking: 52 fields of dim 32 in 4
    # heads, a batch of 2048 (fewer rows in the rehearsal), no mask
    TAB = dict(b=2048 if not rehearse else 64, h=4, l=52, d=8)

    def tab_qkv(dtype):
        return [split_heads(torch.randn(
            (TAB["b"], TAB["l"], TAB["h"] * TAB["d"]), generator=gen,
            device=dev).to(dtype), TAB["h"]) for _ in range(3)]

    def fa_grad_rel(q_, k_, v_, m_, go, what):
        """Kernel 6's gradient (on the card through the autograd Function:
        the kernel forward, the plain-torch backward; in the rehearsal the
        backward itself) against autograd through the plain version, held
        within FA_GRAD_TOL: {dq, dk, dv: max |diff| / max(1, max |grad|)}."""
        if rehearse:
            got = k_fa.flash_attention_backward(q_, k_, v_, m_, go)
        else:
            leaves = [t.detach().requires_grad_() for t in (q_, k_, v_)]
            out_ = k_fa.flash_attention(*leaves, m_)
            require(type(out_.grad_fn).__name__ == "_FlashAttentionBackward",
                    f"flash_attention {what}: no kernel gradient "
                    f"({out_.grad_fn})")
            out_.backward(go)
            got = [t.grad for t in leaves]
        ref_leaves = [t.detach().requires_grad_() for t in (q_, k_, v_)]
        k_fa.flash_attention_plain(*ref_leaves, m_).backward(go)
        sync()
        rel = {f"d{n}": float((g - r.grad).abs().max()) /
               max(1.0, float(r.grad.abs().max()))
               for n, g, r in zip("qkv", got, ref_leaves)}
        require(max(rel.values()) <= FA_GRAD_TOL, f"flash_attention backward "
                f"{what}: {rel} > {FA_GRAD_TOL}")
        return rel

    if "flash_attention" in phases:
        cases = []
        for dtype in (torch.float32, torch.bfloat16):
            cases.append(("path", *path_qkv(dtype), fa_mask))
            cases.append(("tabtransformer", *tab_qkv(dtype), None))
            for b, lq, lk, d in [(3, 77, 200, 8), (3, 77, 200, 16),
                                 (3, 77, 200, 32), (3, 77, 200, 64),
                                 (3, 77, 200, 128), (2, 130, 33, 64),
                                 (3, 77, 128, 64), (3, 77, 200, 256)]:
                qkv = [torch.randn((b, 2, n, d), generator=gen, device=dev
                                   ).to(dtype) for n in (lq, lk, lk)]
                m = torch.rand((b, lk), generator=gen, device=dev) < 0.7
                m[:, 1] = True
                m[0] = False                  # a row with every key masked
                cases.append((f"b{b}_lq{lq}_lk{lk}_d{d}", *qkv, m))
            # the one-pass tile at the encoder's head shape, with leading,
            # middle and trailing holes in the key mask
            qkv = [torch.randn((4, 12, 64, 64), generator=gen, device=dev
                               ).to(dtype) for _ in range(3)]
            m = torch.ones((4, 64), dtype=torch.bool, device=dev)
            m[0, :20] = False
            m[1, 20:40] = False
            m[2, 40:] = False
            m[3] = False
            cases.append(("b4_lq64_lk64_d64_holes", *qkv, m))
        by_case = {}
        for name, q_, k_, v_, m_ in cases:
            got = k_fa.flash_attention(q_, k_, v_, m_)
            ref = k_fa.flash_attention_plain(q_, k_, v_, m_)
            sync()
            require(got.shape == q_.shape and got.dtype == q_.dtype,
                    f"flash_attention {name}: {got.dtype} {tuple(got.shape)}")
            err = float((got.float() - ref.float()).abs().max())
            tol = FA_F32_TOL if q_.dtype == torch.float32 else \
                FA_BF16_TOL * float(v_.float().abs().max())
            key = f"{str(q_.dtype).split('.')[-1]}/{name}"
            by_case[key] = {"max_abs_err": err, "tolerance": tol}
            require(err <= tol, f"flash_attention {key}: max abs diff {err} "
                    f"> {tol}")
        del cases, got, ref
        errs["flash_attention"] = max(c["max_abs_err"] for k, c in
                                      by_case.items() if k.startswith("float32"))
        # the backward: on the card through the autograd Function (the
        # kernel forward, the vanilla backward), in the rehearsal the
        # backward itself; against autograd through the plain version
        enc_mask = fa_mask.clone()
        enc_mask[0] = False                   # a row with every key masked
        backward = {}
        for name, (q_, k_, v_), m_ in (
                ("tabtransformer", tab_qkv(torch.float32), None),
                ("encoder_masked", path_qkv(torch.float32), enc_mask)):
            go = torch.randn(q_.shape, generator=gen, device=dev)
            rel = fa_grad_rel(q_, k_, v_, m_, go, name)
            backward[name] = {"shape": list(q_.shape), "rel_err": rel,
                              "tolerance": FA_GRAD_TOL}
            del q_, k_, v_, go
        # head dims past 128 (128-wide chunks): one head of 256 dims over
        # the encoder's batch, f32, its time beside its bytes bound (not on
        # a main path; the kernels line times the encoder's shape)
        wq, wk, wv = [torch.randn((E["batch"], 1, 64, 256), generator=gen,
                                  device=dev) for _ in range(3)]
        wide = {"shape": [E["batch"], 1, 64, 256],
                "bound_ms": 4 * 4 * wq.numel() / bw * 1e3,
                "ms": Timer(torch, 5).median_ms(
                    lambda i: k_fa.launch_flash_attention(wq, wk, wv, fa_mask))
                if not rehearse else None,
                "library_ms": Timer(torch, 5).median_ms(
                    lambda i: torch.nn.functional.scaled_dot_product_attention(
                        wq, wk, wv, attn_mask=fa_mask[:, None, None, :]))
                if not rehearse else None}
        del wq, wk, wv
        log("flash_attention", path_shape=[E["batch"], heads, 64, head_dim],
            path_valid_keys=int(fa_mask.sum()), cases=by_case, wide_head=wide,
            tab_shape=[TAB[k] for k in "bhld"], backward=backward)

    svc = emb = None
    text_conf = text_conf_file(enc_tmp.name)

    def encoder_service():
        """The encode path's service: BERT-Base from the written files."""
        nonlocal svc, bert_files
        if svc is None:
            if bert_files is None:
                bert_files = enc_syn.write_bert_files(enc_tmp.name, cfg, seed=0)
            svc = TextEncoderService.from_pretrained(
                *bert_files, max_len=64, batch_size=E["batch"],
                use_whitening=True, device=dev)
        return svc

    def check_split_step(model, state, batch, strategy, tag):
        """One more split step whose table update is redone through the
        plain versions of kernels 2-4 on the same row gradients, summed by
        the one-table combine_row_grads (a table's sums do not depend on the
        tables grouped with it). Both run under torch's deterministic
        algorithms."""
        trainer = Trainer(model, table_update="split", split_strategy=strategy,
                          device=dev, seed=0)
        trainer.plan(batch)
        tables = table_params(model)
        _, _, phys, rows = trainer._forward_backward(trainer._put(batch))
        before = {d: (tables[d].detach().clone(),
                      state.table_acc[f"dim{d}"].clone()) for d in phys}
        out = {}
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            trainer._apply_table_updates(state, phys, rows)
            for d in phys:
                p, acc = tables[d].detach(), state.table_acc[f"dim{d}"]
                p_k, acc_k = p.clone(), acc.clone()
                p0, acc0 = before[d]
                p.copy_(p0), acc.copy_(acc0)
                s_, order = torch.sort(phys[d], stable=True)
                summed, uid, _, n_valid = k_rows.segment_row_grads(
                    s_, rows[d].grad[order].float(), num_rows=p.shape[0])
                if strategy == "dense":
                    gd = torch.zeros_like(p)
                    k_rows.scatter_add_rows_plain(uid, summed, gd, n_valid)
                    k_dense.rowwise_adagrad_update_plain(
                        p, acc, gd, lr=trainer.table_lr)
                    del gd
                else:
                    k_sparse.sparse_adagrad_apply_plain(
                        p, acc, uid, summed, n_valid, lr=trainer.table_lr)
                sync()
                touched = torch.zeros(p.shape[0], dtype=torch.bool, device=dev)
                touched[phys[d].long()] = True
                out[f"{tag}/dim{d}"] = check_table_update(
                    torch, f"train step ({tag}, dim{d})", p_k, acc_k, p, acc,
                    p0, acc0, touched)
                del p_k, acc_k, p0, acc0
        finally:
            torch.use_deterministic_algorithms(False)
        return out

    import recommendflow_tpu_torch.ops.attention as attn_mod

    def grads_of(m, batch, d, wide=False):
        """(loss, {dense leaf: gradient}) of one training forward and
        backward of `m` on `batch` on device `d`; `wide`: the batch's floats
        in f64 and Tensor.float() widened to f64 while it runs, so the
        port's casts to f32 (gathered rows, numeric and image features)
        keep an f64 copy in f64."""
        b = to_device(batch, d)
        real = torch.Tensor.float
        if wide:
            b = {k: v.double() if v.is_floating_point() else v
                 for k, v in b.items()}
            torch.Tensor.float = lambda self, *a, **kw: self.double()
        try:
            loss, _ = m.train()(b)
            loss.backward()
        finally:
            torch.Tensor.float = real
        return float(loss.detach()), {n: p.grad for n, p in
                                      m.named_parameters() if p.requires_grad}

    def drop_last_key(real):
        """kernel 6 with each row's last valid key masked out (an
        off-by-one in the key loop): the gradient check's control fault.
        Counts its calls in .calls."""
        def fa(q, k, v, mask=None):
            fa.calls += 1
            m = mask if mask is not None else torch.ones(
                (q.shape[0], k.shape[-2]), dtype=torch.bool, device=q.device)
            n = m.long().cumsum(1)
            return real(q, k, v, m & (n != n[:, -1:]))
        fa.calls = 0
        return fa

    def grad_check(model, batch, what, exact_zero=()):
        """One training forward and backward of `batch` at dropout 0 from
        the same weights, the tables frozen (only the dense gradients are
        compared): f32 on the card, f32 on a CPU copy and f64 on a CPU copy
        (the reference). Each dense leaf's gradient holds if it is within
        GRAD_TOL of the leaf's largest magnitude on the CPU, or else if its
        distance from the f64 gradient is at most GRAD_CPU_FACTOR times the
        CPU f32's own (relative to the f64 leaf's largest magnitude): the
        card's f32 no less exact than the CPU's. An attention key bias
        (`mha.k.bias`, SelfAttention's `attn_*.k.bias`) and the parameters
        named by the suffixes `exact_zero` (their exact gradient is 0) below
        K_BIAS_TOL of the model's largest gradient on the card and the CPU.
        The control: for a model that runs kernel 6, the card copy again
        with drop_last_key, which must break the rule on some leaf. Returns
        the card copy (its gradients kept) and the readings; the readings
        are printed before a failure is raised."""
        card = copy.deepcopy(model)
        for m in card.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        for n, p in card.named_parameters():
            p.requires_grad_("table_dim" not in n)
        card.zero_grad(set_to_none=True)
        control = copy.deepcopy(card)
        cpu = copy.deepcopy(card).to("cpu")
        ref = copy.deepcopy(cpu)
        for n, p in ref.named_parameters():
            if p.requires_grad:
                p.data = p.data.double()
        for b in ref.buffers():
            if b.is_floating_point():
                b.data = b.data.double()
        cpu_dev = torch.device("cpu")
        loss_card, g_card = grads_of(card, batch, dev)
        loss_cpu, g_cpu = grads_of(cpu, batch, cpu_dev)
        loss_ref, g_ref = grads_of(ref, batch, cpu_dev, wide=True)
        real = attn_mod.flash_attention
        attn_mod.flash_attention = fault = drop_last_key(real)
        try:
            _, g_fault = grads_of(control, batch, dev)
        finally:
            attn_mod.flash_attention = real
        sync()
        top = max(float(g.abs().max()) for g in g_cpu.values())

        def readings(g_dev):
            """{leaf: (card vs f64, CPU vs f64, card vs CPU)} and the
            leaves that break the rule."""
            out, bad = {}, []
            for n, g in g_dev.items():
                g, g32, g64 = g.cpu().double(), g_cpu[n].double(), g_ref[n]
                s64 = max(float(g64.abs().max()), 1e-30)
                r = (float((g - g64).abs().max()) / s64,
                     float((g32 - g64).abs().max()) / s64,
                     float((g - g32).abs().max()) / max(
                         float(g32.abs().max()), 1e-30))
                out[n] = r
                if r[2] > GRAD_TOL and r[0] > GRAD_CPU_FACTOR * r[1]:
                    bad.append(n)
            return out, bad

        def is_key_bias(n):
            return n.endswith(("mha.k.bias",) + tuple(exact_zero)) or (
                n.startswith("attn_") and n.endswith(".k.bias"))

        k_bias = max([max(float(g_card[n].abs().max()),
                          float(g_cpu[n].abs().max())) / top
                      for n in g_card if is_key_bias(n)], default=0.0)
        dense = {n: g for n, g in g_card.items() if not is_key_bias(n)}
        got, bad = readings(dense)
        past = {n: r for n, r in got.items() if r[2] > GRAD_TOL}
        info = {"leaves": len(g_cpu), "worst_rel_err": max(
                    r[2] for r in got.values()),
                "worst_vs_f64": {"card": max(r[0] for r in got.values()),
                                 "cpu": max(r[1] for r in got.values())},
                "leaves_past_tolerance": {n: list(r) for n, r in past.items()},
                "worst_leaves": {n: list(r) for n, r in sorted(
                    got.items(), key=lambda kv: -kv[1][0])[:4]},
                "k_bias_rel": k_bias, "tolerance": GRAD_TOL,
                "cpu_factor": GRAD_CPU_FACTOR,
                "k_bias_tolerance": K_BIAS_TOL, "largest_grad": top,
                "loss_card": loss_card, "loss_cpu": loss_cpu,
                "loss_f64": loss_ref}
        if fault.calls:
            # how far past the rule the control's worst leaf lands: > 1 is
            # a fault caught
            ctl, _ = readings({n: g_fault[n] for n in dense})
            info["control"] = {"fault": "kernel 6 drops each row's last "
                               "valid key", "calls": fault.calls,
                               "worst_rel_err": max(r[2] for r in ctl.values()),
                               "margin": max(min(r[2] / GRAD_TOL,
                                                 r[0] / max(GRAD_CPU_FACTOR * r[1], 1e-30))
                                             for r in ctl.values())}
        del cpu, ref, control, g_fault
        ok = (not bad and k_bias <= K_BIAS_TOL
              and info.get("control", {"margin": 2.0})["margin"] > 1.0)
        if not ok:
            log("grad_check_failed", model=what, **info)
        require(not bad, f"{what}: gradients on the card vs the CPU past "
                f"{GRAD_TOL} of their largest and farther from f64 than "
                f"{GRAD_CPU_FACTOR}x the CPU's: "
                f"{ {n: got[n] for n in bad} }")
        require(k_bias <= K_BIAS_TOL, f"{what}: an attention key bias "
                f"gradient at {k_bias} of the largest > {K_BIAS_TOL}")
        require(ok, f"{what}: the control fault was not caught: "
                f"{info.get('control')}")
        return card, info

    # ----------------------------------------------------------- 8. slice
    counters = {"gather_rows": k_rows.gather_rows,
                "grouped_score_max": k_scan.grouped_score_max,
                "scatter_add_rows": k_rows.scatter_add_rows,
                "rowwise_adagrad_update": k_dense.rowwise_adagrad_update,
                "sparse_adagrad_apply": k_sparse.sparse_adagrad_apply,
                "combine_row_grads": k_comb.combine_row_grads,
                "flash_attention": k_fa.flash_attention}

    by_dtype = k_scan.grouped_score_max.launches_by_dtype
    by_row_bytes = k_rows.gather_rows.launches_by_row_bytes
    by_tables = k_comb.combine_row_grads.launches_by_tables

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0
        for form in by_dtype:
            by_dtype[form] = 0
        by_row_bytes.clear()
        by_tables.clear()

    def read_counts():
        """Launches by kernel, the uint8 and bf16 forms of grouped_score_max
        apart (they are counted in grouped_score_max's total as well),
        gather_rows' launches by row width in bytes and combine_row_grads'
        grouped calls by their number of tables."""
        return {**{name: fn.launches for name, fn in counters.items()},
                "grouped_score_max_uint8": by_dtype["uint8"],
                "grouped_score_max_bf16": by_dtype["bfloat16"],
                "gather_rows_by_row_bytes": dict(by_row_bytes),
                "combine_row_grads_by_tables": dict(by_tables)}

    launches = {"slice": {}, "train": {}, "ranking": {}, "train_options": {},
                "long_runs": {}, "dispatch": {}, "attention_ranking": {},
                "text_recall": {}, "simbert": {},
                "export_serve": {}, "sq_search": {}, "sq_search_bf16": {},
                "host_tier": {}, "parallel": {}, "cascade": {}, "encode": {}}
    model = None
    if "slice" in phases or "train" in phases:
        model, _ = build_network(bench_conf.networks["class"],
                                 {"conf": bench_conf, "device": dev, "seed": 0})
    if "slice" in phases:
        reset_counts()
        sync()
        t0 = time.perf_counter()
        out = predict(model, (synthetic_batch(model.schema, S["batch"], seed=i)
                              for i in range(S["n_batches"])), dev)
        sync()
        predict_s = time.perf_counter() - t0
        n_rows = S["batch"] * S["n_batches"]
        require(out["user"].shape == (n_rows, 128) and out["ad"].shape ==
                (n_rows, 128), f"predict shapes {out['user'].shape}")
        require(bool(np.isfinite(out["user"]).all() and
                     np.isfinite(out["ad"]).all()), "non-finite embeddings")
        norms = np.linalg.norm(out["user"], axis=1)
        require(bool(np.allclose(norms, 1.0, atol=1e-4)), "user vectors not unit")
        t0 = time.perf_counter()
        corpus_np, labels, pos = build_eval_corpus(out["user"], out["ad"],
                                                   out["label"])
        corpus_s = time.perf_counter() - t0
        qv = out["user"][pos][:S["search_q"]]
        lab = labels[:S["search_q"]]
        searcher = FlatSearcher(128, metric="cos", device=dev).train(corpus_np)
        n_pad = int(searcher._vecs.shape[0])
        sync()
        t0 = time.perf_counter()
        metrics = batch_compute_recall_score(searcher, qv, lab, [10, 100])
        sync()
        first_search_s = time.perf_counter() - t0
        launches["slice"] = read_counts()
        require(all(launches["slice"][k] > 0 for k in
                    ("gather_rows", "grouped_score_max")) or rehearse,
                f"a kernel was not launched on the serving path: "
                f"{launches['slice']}")
        require(all(math.isfinite(v) for v in metrics.values()),
                f"non-finite metrics {metrics}")
        # the top-100 against a plain exact search
        _, s_got, i_got = searcher.search(qv, topk=100)
        qn = torch.nn.functional.normalize(torch.from_numpy(qv).to(dev), dim=1)
        cn = searcher._vecs[:searcher.num_items]
        exact = qn @ cn.T
        s_ref, i_ref = torch.topk(exact, 100, dim=1)
        s_ref, i_ref = s_ref.cpu().numpy(), i_ref.cpu().numpy()
        s_of_got = torch.gather(exact, 1, torch.from_numpy(i_got).to(dev)
                                ).cpu().numpy()
        del exact
        score_err = float(np.abs(s_got - s_ref).max())
        tie_err = float(np.abs(s_of_got - s_ref).max())
        idx_match = float((i_got == i_ref).mean())
        require(score_err <= 1e-5, f"top-100 scores differ by {score_err}")
        require(tie_err <= 1e-5, f"top-100 indices differ beyond ties "
                f"({tie_err})")
        require(all(len(set(r)) == 100 for r in i_got), "duplicate indices")
        searcher_times = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            searcher.search(qv, topk=100)
            sync()
            searcher_times.append(time.perf_counter() - t0)
        log("slice", rows=n_rows, batch=S["batch"],
            predict_ms_per_batch=predict_s / S["n_batches"] * 1e3,
            eval_corpus_s=corpus_s, corpus_items=searcher.num_items,
            n_pad=n_pad, queries=len(qv),
            first_search_s=first_search_s,
            search_ms_per_4096=sorted(searcher_times)[1] * 1e3
            * 4096 / len(qv), metrics=metrics, top100_score_err=score_err,
            top100_tie_err=tie_err, top100_index_match=idx_match,
            launches=launches["slice"],
            peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                         if not rehearse else None))
        del out, searcher, cn, qn
        if not rehearse:
            torch.cuda.empty_cache()

    # ----------------------------------------------------------- 9. train
    if "train" in phases:
        from recommendflow_tpu_torch.retrieval.eval import make_recall_evaluator
        from recommendflow_tpu_torch.train.callbacks import EvalCallback
        if rehearse:   # the bench table does not train at CPU speed
            demo = Configuration(DEMO_CONF)
            model, _ = build_network(demo.networks["class"],
                                     {"conf": demo, "device": dev, "seed": 0})
        T = dict(warm=3, dense=20, sparse_set=20, table_dense=5,
                 eval_batches=512) if not rehearse else \
            dict(warm=1, dense=2, sparse_set=2, table_dense=2, eval_batches=4)
        seeds = iter(range(100_000, 200_000))

        def batches(n):
            return [synthetic_batch(model.schema, S["batch"], seed=next(seeds))
                    for _ in range(n)]

        runs = [("warm", "split", "dense"), ("dense", "split", "dense"),
                ("sparse_set", "split", "sparse_set"),
                ("table_dense", "dense", "dense")]
        data = {name: batches(T[name]) for name, _, _ in runs}
        eval_ds = batches(T["eval_batches"])
        if not rehearse:
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        state, per_run, losses = None, {}, []
        for name, mode, strategy in runs:
            trainer = Trainer(model, table_update=mode, split_strategy=strategy,
                              device=dev, seed=0)
            cbs = [EvalCallback(make_recall_evaluator(eval_ds, topk_list=[10, 100]))
                   ] if name == "table_dense" else []
            res = trainer.fit(data[name], state=state, callbacks=cbs,
                              resume_data=False, verbose=False)
            state, logs = res["state"], res["history"][-1]
            losses.append(logs["loss"])
            per_run[name] = {
                "steps": T[name], "loss": logs["loss"],
                "examples_per_s": logs["examples_per_sec"],
                "ms_per_step": S["batch"] / logs["examples_per_sec"] * 1e3}
        sync()
        launches["train"] = read_counts()
        recall = {k: v for k, v in logs.items() if k.startswith("val_")}
        require(all(math.isfinite(x) for x in losses), f"losses {losses}")
        # the training path runs the table kernels, gather_rows and, in
        # the recall evaluation, grouped_score_max; not the encoder's
        require(all(launches["train"][k] > 0 for k in (
            "gather_rows", "grouped_score_max", "scatter_add_rows",
            "rowwise_adagrad_update", "sparse_adagrad_apply")) or rehearse,
                f"a kernel was not launched on the training path: "
                f"{launches['train']}")
        require(bool(recall) and all(math.isfinite(v) for v in recall.values()),
                f"recall evaluation {recall}")
        update_check = {}
        for strategy in ("dense", "sparse_set"):
            update_check.update(check_split_step(model, state, batches(1)[0],
                                                 strategy, strategy))
        log("train", config=os.path.basename(BENCH_CONF) if not rehearse
            else os.path.basename(DEMO_CONF), batch=S["batch"],
            dropout=float(model.user_tower.drop.p) if model.user_tower.drop
            else 0.0, runs=per_run, recall=recall, launches=launches["train"],
            update_check=update_check,
            peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                         if not rehearse else None))
        del state, trainer, data, eval_ds
    del model
    if not rehearse:
        torch.cuda.empty_cache()

    # --------------------------------------------------------- 10. ranking
    if "ranking" in phases:
        rconf = Configuration(RANK_CONF if not rehearse else DEMO_RANK_CONF)
        if rehearse:   # the bench table does not train at CPU speed
            rconf.networks["class"] = "recommendflow_tpu.models.ranking.dcn.Dcn"
        RK = dict(batch=2048, serve_batches=64, check_rows=256, warm=3,
                  steps=20, eval_batches=16, reps=20) if not rehearse else \
            dict(batch=64, serve_batches=4, check_rows=32, warm=1, steps=2,
                 eval_batches=2, reps=2)
        model, _ = build_network(rconf.networks["class"],
                                 {"conf": rconf, "device": dev, "seed": 0})
        rschema = model.schema
        (rdim,) = table_params(model)
        rtable = table_params(model)[rdim]
        rseeds = iter(range(300_000, 400_000))

        def rbatches(n, zipf=0.0):
            return [synthetic_batch(rschema, RK["batch"], seed=next(rseeds),
                                    zipf=zipf) for _ in range(n)]

        if not rehearse:
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        # serving: scores of serve_batches x batch rows
        serve = rbatches(RK["serve_batches"])
        sync()
        t0 = time.perf_counter()
        out = predict(model, serve, dev)
        sync()
        serve_s = time.perf_counter() - t0
        n_rows = RK["batch"] * RK["serve_batches"]
        score = out["score"]
        require(score.shape == (n_rows,) and bool(np.isfinite(score).all())
                and bool(((score > 0) & (score < 1)).all()),
                f"ranking scores: shape {score.shape}, "
                f"range [{score.min()}, {score.max()}]")
        require(read_counts()["gather_rows"] > 0 or rehearse,
                "gather_rows did not launch on the ranking serving path")
        few = {k: v[:RK["check_rows"]] for k, v in serve[0].items()}
        del serve, out
        # training: the planner ("auto"), then each strategy on its own,
        # each run ending with the AUC on held-out batches
        eval_ds = rbatches(RK["eval_batches"])
        runs = [("warm", "auto", RK["warm"], 0.0),
                ("auto", "auto", RK["steps"], 0.0),
                ("dense", "dense", RK["steps"], 0.0),
                ("sparse_set", "sparse_set", RK["steps"], 0.0),
                ("auto_zipf1.2", "auto", RK["steps"], 1.2)]
        state, per_run = None, {}
        for name, strategy, n, zipf in runs:
            trainer = Trainer(model, split_strategy=strategy, device=dev, seed=0)
            res = trainer.fit(rbatches(n, zipf), valid_ds=eval_ds, state=state,
                              resume_data=False, verbose=False)
            state, logs = res["state"], res["history"][-1]
            require(math.isfinite(logs["loss"]) and
                    0.0 <= logs.get("val_auc", -1.0) <= 1.0,
                    f"ranking run {name}: {logs}")
            per_run[name] = {
                "steps": n, "zipf": zipf,
                "split": {f"dim{d}": s_ for d, s_ in trainer._split_dims.items()},
                "loss": logs["loss"], "val_auc": logs["val_auc"],
                "examples_per_s": logs["examples_per_sec"],
                "ms_per_step": RK["batch"] / logs["examples_per_sec"] * 1e3}
        sync()
        launches["ranking"] = read_counts()
        require(all(launches["ranking"][k] > 0 for k in (
            "gather_rows", "scatter_add_rows", "rowwise_adagrad_update",
            "sparse_adagrad_apply")) or rehearse,
                f"a kernel was not launched on the ranking path: "
                f"{launches['ranking']}")
        # the trained weights on the CPU (TF32 off on the card)
        model.eval()
        cpu_model = copy.deepcopy(model).to("cpu")
        with torch.no_grad():
            card_logit = model(to_device(few, dev))["logit"].cpu()
            cpu_logit = cpu_model(to_device(few, torch.device("cpu")))["logit"]
        cpu_err = float((card_logit - cpu_logit).abs().max())
        del cpu_model
        require(cpu_err <= RANK_CPU_TOL, f"ranking logits on the card vs the "
                f"CPU: {cpu_err} > {RANK_CPU_TOL}")
        update_check = {}
        for strategy in ("dense", "sparse_set"):
            for zipf in (0.0, 1.2):
                update_check.update(check_split_step(
                    model, state, rbatches(1, zipf)[0], strategy,
                    f"{strategy}/zipf{zipf}"))
        # the host never waits on the card in one predict batch's embed
        # pass or in the split path's gather: both launch gather_rows
        # unchecked (the host checked the batch's ids); CUDA's sync debug
        # mode raises on any wait. A warm-up pass first copies the slot
        # offsets to the card (once).
        sb = to_device(rbatches(1)[0], dev)
        strainer = Trainer(model, split_strategy="sparse_set", device=dev,
                           seed=0)
        strainer.plan(sb)
        model.eval()
        no_wait = {"embed_pass": lambda: model.embedder(sb),
                   "split_gather": lambda: strainer.split_rows(sb)}
        with torch.no_grad():
            for what, fn in no_wait.items():
                fn()
                sync()
                if not rehearse:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    fn()
                except RuntimeError as e:
                    raise RuntimeError(f"ranking {what} made the host wait "
                                       f"on the card: {e}") from e
                finally:
                    if not rehearse:
                        torch.cuda.set_sync_debug_mode("default")
        del sb, strainer
        # the planner's cost model: both strategies' split_table_update (the
        # sort and duplicate sum included) at the bench_recall and the
        # bench_ranking shapes, and the ranking table at half a batch's ids
        planner = None
        if not rehearse:
            fused = fused_group_ids(rschema, to_device(rbatches(1)[0], dev))
            rank_ids = physical_ids(rtable, rdim, fused[rdim]).to(torch.int32)
            shapes = {"bench_recall": (stored.clone(), ids_for(10_002) // 4),
                      "bench_ranking": (rtable.detach(), rank_ids),
                      "bench_ranking_half_ids": (rtable.detach(),
                                                 rank_ids[:rank_ids.numel() // 2])}
            names = list(shapes)
            timer = Timer(torch, RK["reps"])
            planner = {}
            for shape, (p_, ids_) in shapes.items():
                acc_ = init_accumulator(p_)
                g_ = (torch.randn((ids_.numel(), p_.shape[1]), generator=gen,
                                  device=dev) * 0.01).to(p_.dtype)
                ms = {s_: timer.median_ms(
                    lambda i, s_=s_: split_table_update(
                        p_, acc_, ids_, g_, lr=LR, strategy=s_))
                    for s_ in ("dense", "sparse_set")}
                nbytes = p_.numel() * p_.element_size()
                dense_s, sparse_s = split_costs(nbytes, ids_.numel())
                planner[shape] = {
                    "table_bytes": nbytes, "ids": ids_.numel(), "ms": ms,
                    "faster": min(ms, key=ms.get),
                    "planned": plan_strategy(nbytes, ids_.numel()),
                    "model_ms": {"dense": dense_s * 1e3,
                                 "sparse_set": sparse_s * 1e3}}
                del acc_, g_
            del shapes
            require(planner["bench_ranking"]["planned"] ==
                    planner["bench_ranking"]["faster"],
                    f"the planner's choice at bench_ranking is not the faster "
                    f"strategy: {planner['bench_ranking']}")
            # dense: seconds per table byte, least squares through 0 over the
            # two tables; sparse_set: a line over the three id counts
            by = [(planner[k]["table_bytes"], planner[k]["ms"]["dense"] / 1e3)
                  for k in ("bench_recall", "bench_ranking")]
            per_byte = sum(b * t for b, t in by) / sum(b * b for b, _ in by)
            slope, icpt = np.polyfit(
                [planner[k]["ids"] for k in names],
                [planner[k]["ms"]["sparse_set"] / 1e3 for k in names], 1)
            planner["fit"] = {"dense_s_per_byte": per_byte,
                              "sparse_s_per_id": float(slope),
                              "sparse_fixed_s": float(icpt)}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 if not rehearse \
            else None
        # where a step's time goes: 10 steps per split strategy under
        # torch.profiler (wall and device-busy ms per step, idle share)
        profiled = None
        if not rehearse:
            from recommendflow_tpu_torch.tools.profile_slice import (
                profile_training)
            profiled = {st["mode"]: {k: st[k] for k in (
                "per_step_wall_ms", "per_step_device_ms", "idle_share",
                "host_syncs_per_step", "top_ms", "port_kernels")}
                for st in profile_training(
                    model, dev, 10, batch=RK["batch"],
                    modes=(("split", "dense"), ("split", "sparse_set")))}
        log("ranking", config=os.path.basename(RANK_CONF) if not rehearse
            else os.path.basename(DEMO_RANK_CONF) + " (Dcn)",
            table=list(rtable.shape), table_dtype=str(rtable.dtype),
            batch=RK["batch"], serve_rows=n_rows,
            serve_ms_per_batch=serve_s / RK["serve_batches"] * 1e3,
            cpu_vs_card_logit=cpu_err, cpu_tolerance=RANK_CPU_TOL,
            dropout=float(model.deep.drop.p) if model.deep.drop else 0.0,
            runs=per_run, launches=launches["ranking"],
            update_check=update_check, planner=planner, profiled=profiled,
            host_waits={what: 0 for what in no_wait}, peak_mem_gb=peak_gb)
        del model, state, trainer, eval_ds, rtable
        if not rehearse:
            torch.cuda.empty_cache()

    # ---------------------------------------------------- 11. train_options
    def train_options_phase():
        """Phase 11 (the module docstring); its names stay its own."""
        from recommendflow_tpu_torch.ops.embedding import touched_stored_rows
        from recommendflow_tpu_torch.train.optimizers import (
            make_lr_schedule, make_optimizer, make_partitioned_optimizer,
            sparse_rowwise_adagrad_update, sparse_rowwise_adagrad_update_plain)
        from recommendflow_tpu_torch.train.trainer import (
            current_learning_rate, plan_table_update, table_update_costs)
        TO = dict(rank_batch=2048, rec_batch=1024, steps=3, reps=20) \
            if not rehearse else \
            dict(rank_batch=64, rec_batch=64, steps=2, reps=2)
        tseeds = iter(range(700_000, 800_000))
        launches["train_options"] = {}

        def add_counts(counts):
            tot = launches["train_options"]
            for k, v in counts.items():
                if isinstance(v, int):
                    tot[k] = tot.get(k, 0) + v

        def run_steps(trainer, state, batches_, what):
            """One warm-up step, then the timed ones (host clock, ending in
            a synchronise): (state, losses, ms a step, launches). The
            launch counts are reset before and read after, and added to the
            phase's."""
            reset_counts()
            state, m = trainer.train_step(state, batches_[0])
            losses = [float(m["loss"])]
            sync()
            t0 = time.perf_counter()
            for b in batches_[1:]:
                state, m = trainer.train_step(state, b)
                losses.append(m["loss"])
            sync()
            ms = (time.perf_counter() - t0) / max(len(batches_) - 1, 1) * 1e3
            losses = [float(x) for x in losses]
            counts = read_counts()
            add_counts(counts)
            require(all(math.isfinite(x) for x in losses),
                    f"train_options {what}: losses {losses}")
            return state, losses, ms, counts

        def need(counts, what, on, off=()):
            require(rehearse or (all(counts[k] > 0 for k in on)
                                 and all(counts[k] == 0 for k in off)),
                    f"train_options {what}: launches {counts} (want {on} "
                    f"launched, {off} not)")

        def id_count(schema_, batch_, dim):
            return sum(int(np.prod(batch_[s.name].shape)) for s in
                       (schema_.slots[n] for n in schema_.order)
                       if s.kind == "sparse" and s.dim == dim)

        timer = Timer(torch, TO["reps"]) if not rehearse else None

        def time_updates(schema_, p, acc, g, batch_, dim):
            """The legacy planner's two updates of one table from the same
            dense gradient, timed by CUDA events: "dense" over the table
            (rowwise_adagrad_update), "sparse" on the batch's touched rows
            (touched_stored_rows' sort included)."""
            key = f"dim{dim}"
            n_ids = id_count(schema_, batch_, dim)
            nbytes = p.numel() * p.element_size()
            ms = {"dense": timer.median_ms(
                      lambda i: k_dense.rowwise_adagrad_update(p, acc, g,
                                                               lr=LR)),
                  "sparse": timer.median_ms(
                      lambda i: sparse_rowwise_adagrad_update(
                          p, acc, g, touched_stored_rows(
                              schema_, {key: p}, batch_)[key], lr=LR))}
            dense_s, sparse_s = table_update_costs(nbytes, n_ids)
            faster = min(ms, key=ms.get)
            planned = plan_table_update(nbytes, n_ids)
            return {"table": list(p.shape), "table_bytes": nbytes,
                    "ids": n_ids, "ms": ms, "faster": faster,
                    "planned": planned,
                    "planned_over_faster": ms[planned] / ms[faster],
                    "model_ms": {"dense": dense_s * 1e3,
                                 "sparse": sparse_s * 1e3}}

        # (a) Dcn at bench_ranking width: table_update "sparse", then the
        # same steps with "dense"
        rconf = Configuration(RANK_CONF if not rehearse else DEMO_RANK_CONF)
        if rehearse:
            rconf.networks["class"] = "recommendflow_tpu.models.ranking.dcn.Dcn"
        model, _ = build_network(rconf.networks["class"],
                                 {"conf": rconf, "device": dev, "seed": 0})
        rbs = [synthetic_batch(model.schema, TO["rank_batch"],
                               seed=next(tseeds))
               for _ in range(TO["steps"] + 1)]
        (rdim,) = table_params(model)
        rkey = f"dim{rdim}"
        if not rehearse:
            torch.cuda.reset_peak_memory_stats()
        dcn, state = {}, None
        for mode, on, off in (("sparse", ("gather_rows", "scatter_add_rows",
                                          "sparse_adagrad_apply"),
                               ("rowwise_adagrad_update",)),
                              ("dense", ("gather_rows", "scatter_add_rows",
                                         "rowwise_adagrad_update"),
                               ("sparse_adagrad_apply",))):
            trainer = Trainer(model, table_update=mode, device=dev, seed=0)
            if state is None:
                state = trainer.init_state(rbs[0])
            else:
                trainer.plan(rbs[0])
            require(trainer._sparse_dims == ([rdim] if mode == "sparse"
                                             else []),
                    f"train_options: {mode} planned {trainer._sparse_dims}")
            state, losses, ms, counts = run_steps(trainer, state, rbs,
                                                  f"dcn/{mode}")
            need(counts, f"dcn/{mode}", on, off)
            dcn[mode] = {"losses": losses, "ms_per_step": ms,
                         "launches": counts}
        # the host never waits on the card in a touched-row step (a batch
        # already on the card; CUDA's sync debug mode raises on any wait)
        trainer = Trainer(model, table_update="sparse", device=dev, seed=0)
        trainer.plan(rbs[0])
        db = trainer._put(rbs[1])
        sync()
        if not rehearse:
            torch.cuda.set_sync_debug_mode("error")
        try:
            state, _ = trainer._step(state, db)
        except RuntimeError as e:
            raise RuntimeError(f"train_options: a touched-row step made the "
                               f"host wait on the card: {e}") from e
        finally:
            if not rehearse:
                torch.cuda.set_sync_debug_mode("default")
        # one more touched-row step whose table update is redone through the
        # plain versions on the same dense gradient
        db = trainer._put(rbs[2])
        _, _, phys_, rows_ = trainer._forward_backward(db)
        state.optimizer.step()
        rtab = table_params(model)[rdim]
        p, acc = rtab.detach(), state.table_acc[rkey]
        g_dense = rtab.grad.clone()
        sids = touched_stored_rows(model.schema, {rkey: p}, db)[rkey]
        p0, acc0 = p.clone(), acc.clone()
        trainer._apply_table_updates(state, phys_, rows_, db)
        require(rtab.grad is None, "the touched-row update kept the gradient")
        p_k, acc_k = p.clone(), acc.clone()
        p.copy_(p0), acc.copy_(acc0)
        sparse_rowwise_adagrad_update_plain(p, acc, g_dense, sids,
                                            lr=trainer.table_lr)
        sync()
        touched = torch.zeros(p.shape[0], dtype=torch.bool, device=dev)
        touched[sids.long()] = True
        sparse_check = check_table_update(
            torch, "train_options sparse step", p_k, acc_k, p, acc, p0, acc0,
            touched)
        del p_k, acc_k, p0, acc0, g_dense
        # (b) the legacy planner at the bench_ranking table: a batch's dense
        # gradient, both updates timed, the choice the faster or within 5%
        planner = {}
        if not rehearse:
            _, _, phys_, rows_ = trainer._forward_backward(db)
            g_dense = rtab.grad.detach()
            rtab.grad = None
            planner["bench_ranking"] = time_updates(model.schema, p, acc,
                                                    g_dense, db, rdim)
            half = {k: v[:TO["rank_batch"] // 2] for k, v in db.items()}
            planner["bench_ranking_half_ids"] = time_updates(
                model.schema, p, acc, g_dense, half, rdim)
            del g_dense
        rank_peak = torch.cuda.max_memory_allocated() / 1e9 \
            if not rehearse else None
        del model, state, trainer, db, rtab, p, acc
        if not rehearse:
            torch.cuda.empty_cache()

        # (c)-(f) Dssm at bench_recall width
        dconf = Configuration(BENCH_CONF if not rehearse else DEMO_CONF)
        model, _ = build_network(dconf.networks["class"],
                                 {"conf": dconf, "device": dev, "seed": 0})
        dbs = [synthetic_batch(model.schema, TO["rec_batch"],
                               seed=next(tseeds))
               for _ in range(TO["steps"] + 1)]
        ddim = max(table_params(model))
        if not rehearse:
            trainer = Trainer(model, table_update="sparse", device=dev, seed=0)
            st = trainer.init_state(dbs[0])
            db = trainer._put(dbs[1])
            _, _, phys_, rows_ = trainer._forward_backward(db)
            dtab = table_params(model)[ddim]
            g_dense = dtab.grad.detach()
            dtab.grad = None
            model.zero_grad(set_to_none=True)
            planner["bench_recall"] = time_updates(
                model.schema, dtab.detach(), st.table_acc[f"dim{ddim}"],
                g_dense, db, ddim)
            del trainer, st, db, g_dense, dtab
            # the fit behind LEGACY_* (train/trainer.py): dense seconds per
            # table byte through 0 over both tables, sparse a line over the
            # three id counts
            names = ("bench_recall", "bench_ranking", "bench_ranking_half_ids")
            by = [(planner[k]["table_bytes"], planner[k]["ms"]["dense"] / 1e3)
                  for k in ("bench_recall", "bench_ranking")]
            slope, icpt = np.polyfit(
                [planner[k]["ids"] for k in names],
                [planner[k]["ms"]["sparse"] / 1e3 for k in names], 1)
            planner["fit"] = {
                "dense_s_per_byte": sum(b * t for b, t in by)
                / sum(b * b for b, _ in by),
                "sparse_s_per_id": float(slope), "sparse_fixed_s": float(icpt)}
            for k in ("bench_recall", "bench_ranking"):
                require(planner[k]["planned_over_faster"] <= 1.05,
                        f"train_options: the legacy planner's choice at {k} "
                        f"is neither the faster update nor within 5% of it: "
                        f"{planner[k]}")
        opt_runs = {}
        specs = {"adam": make_optimizer(1e-3, "adam", clip_norm=1.0),
                 "adamw": make_optimizer(1e-3, "adamw", weight_decay=1e-4,
                                         clip_norm=1.0),
                 "adagrad": make_optimizer(1e-3, "adagrad", clip_norm=1.0),
                 "sgd": make_optimizer(1e-3, "sgd", clip_norm=1.0),
                 "lamb": make_optimizer(1e-3, "lamb", weight_decay=1e-4,
                                        clip_norm=1.0),
                 "partitioned_adamw": make_partitioned_optimizer(
                     1e-3, dense_optimizer="adamw", weight_decay=1e-4)}
        for name, spec in specs.items():
            trainer = Trainer(model, optimizer=spec, device=dev, seed=0)
            state = trainer.init_state(dbs[0])
            state, losses, ms, counts = run_steps(trainer, state, dbs,
                                                  f"dssm/{name}")
            table_kernel = ("rowwise_adagrad_update",)
            need(counts, f"dssm/{name}",
                 ("gather_rows", "scatter_add_rows")
                 + (table_kernel if spec.partitioned else ()),
                 ("sparse_adagrad_apply",)
                 + (() if spec.partitioned else table_kernel))
            opt_runs[name] = {"losses": losses, "ms_per_step": ms,
                              "launches": counts}
            del trainer, state
        # (d) a cosine schedule with warmup: the LR each step equals
        # make_lr_schedule's value at its update count
        sched = {"type": "cosine", "warmup_steps": 2, "decay_steps": 6,
                 "min_ratio": 0.1}
        want = make_lr_schedule(1e-3, **sched)
        trainer = Trainer(model, learning_rate=1e-3, lr_schedule=sched,
                          device=dev, seed=0)
        state = trainer.init_state(dbs[0])
        lrs = [current_learning_rate(state)]
        for i, b in enumerate(dbs * 2):
            state, m = trainer.train_step(state, b)
            lrs.append(current_learning_rate(state))
            require(lrs[-1] == want(i) and math.isfinite(float(m["loss"])),
                    f"train_options schedule: step {i} LR {lrs[-1]} != "
                    f"{want(i)}")
        require(lrs[1] == 0.0 and lrs[0] == want(0),
                f"train_options schedule: warmup LRs {lrs[:3]}")
        del trainer, state, model
        if not rehearse:
            torch.cuda.empty_cache()
        # (e) logQ: item_id at 1 << 20 buckets; the stream advances a step
        # a training step and its intervals fill in
        lconf = Configuration(BENCH_CONF if not rehearse else DEMO_CONF)
        lconf.networks["logq_feature"] = "item_id"
        lconf.networks["logq_buckets"] = 1 << 20
        model, _ = build_network(lconf.networks["class"],
                                 {"conf": lconf, "device": dev, "seed": 0})
        trainer = Trainer(model, device=dev, seed=0)
        state = trainer.init_state(dbs[0])
        seen, fsteps, llosses = [], [], []
        reset_counts()
        for b in dbs:
            state, m = trainer.train_step(state, b)
            llosses.append(float(m["loss"]))
            fsteps.append(int(model.freq.step))
            seen.append(int((model.freq.interval > 0).sum()))
        add_counts(read_counts())
        require(fsteps == list(range(1, len(dbs) + 1)),
                f"train_options logq: stream steps {fsteps}")
        require(all(b_ > a_ for a_, b_ in zip(seen, seen[1:])) and seen[0] > 0,
                f"train_options logq: buckets seen {seen}")
        require(all(math.isfinite(x) for x in llosses),
                f"train_options logq: losses {llosses}")
        del trainer, state, model
        # (f) compute_dtype bfloat16: one predict batch within BF16_ROW_TOL
        # of the f32 model with the same weights
        f32_model, _ = build_network(dconf.networks["class"],
                                     {"conf": dconf, "device": dev, "seed": 0})
        bconf = Configuration(BENCH_CONF if not rehearse else DEMO_CONF)
        bconf.networks["compute_dtype"] = "bfloat16"
        bf16_model, _ = build_network(bconf.networks["class"],
                                      {"conf": bconf, "device": dev, "seed": 0})
        bf16_model.load_state_dict(f32_model.state_dict())
        pb = dbs[0]
        ref = predict(f32_model, [pb], dev)
        got = predict(bf16_model, [pb], dev)
        bf16_err = {k: float(np.linalg.norm(got[k] - ref[k], axis=1).max())
                    for k in ("user", "ad")}
        require(all(0 < e <= BF16_ROW_TOL for e in bf16_err.values())
                and all(np.isfinite(got[k]).all() for k in ("user", "ad")),
                f"train_options bf16 predict: row L2 vs f32 {bf16_err} "
                f"(tolerance {BF16_ROW_TOL})")
        del f32_model, bf16_model
        if not rehearse:
            torch.cuda.empty_cache()
        log("train_options", card=card,
            ranking={"config": os.path.basename(
                RANK_CONF if not rehearse else DEMO_RANK_CONF),
                     "batch": TO["rank_batch"], "table": rkey,
                     "runs": dcn, "host_waits_sparse_step": 0,
                     "update_check": sparse_check, "peak_mem_gb": rank_peak},
            planner=planner, recall_config=os.path.basename(
                BENCH_CONF if not rehearse else DEMO_CONF),
            recall_batch=TO["rec_batch"],
            optimizers=opt_runs,
            schedule={"spec": sched, "lrs": lrs},
            logq={"buckets": 1 << 20, "stream_steps": fsteps,
                  "buckets_seen": seen, "losses": llosses},
            bf16={"row_l2_vs_f32": bf16_err, "tolerance": BF16_ROW_TOL},
            launches=launches["train_options"])

    if "train_options" in phases:
        train_options_phase()

    # -------------------------------------------------------- 12. long_runs
    def long_runs_phase():
        """Phase 12 (the module docstring); its names stay its own."""
        from recommendflow_tpu_torch.cli import finetune as ft_cli
        from recommendflow_tpu_torch.cli import predict as pred_cli
        from recommendflow_tpu_torch.cli import train as train_cli
        from recommendflow_tpu_torch.data.pipeline import make_dataset
        from recommendflow_tpu_torch.tools.profile_slice import LaunchRecorder
        from recommendflow_tpu_torch.train.callbacks import Callback
        from recommendflow_tpu_torch.train.checkpoint import (
            read_checkpoint, restore_checkpoint, state_to_host)
        from recommendflow_tpu_torch.train.monitor import PromotionBlocked
        from recommendflow_tpu_torch.train.trainer import \
            install_preemption_handler
        LR_ = dict(batch=1024, per_epoch=6, kill_at=3, profiled=8,
                   profile=(3, 6), cli_rows=16 * 1024) if not rehearse else \
            dict(batch=64, per_epoch=6, kill_at=3, profiled=8,
                 profile=(3, 6), cli_rows=16 * 64)
        lpath = BENCH_CONF if not rehearse else DEMO_CONF
        lconf = Configuration(lpath)
        lschema = compile_schema(lconf.features)

        class Epochs:
            """LR_["per_epoch"] synthetic batches an epoch (other seeds each
            epoch), with a length and iter_from, as the record Dataset."""

            def __init__(self, n_epochs, per_epoch, seed):
                self.epochs = [[synthetic_batch(lschema, LR_["batch"],
                                                seed=seed + 1000 * e + i)
                                for i in range(per_epoch)]
                               for e in range(n_epochs)]

            def __len__(self):
                return len(self.epochs[0])

            def __iter__(self):
                return self.iter_from(0)

            def iter_from(self, skip=0, epoch=0):
                return iter(self.epochs[epoch][skip:])

        class SigtermAt:
            """Sends this process SIGTERM as batch `n` of an epoch is drawn
            (prefetch's thread draws it; the handler runs in the main
            thread) and keeps the wall time of the signal."""

            def __init__(self, inner, n):
                self.inner, self.n, self.sent = inner, n, None

            def __len__(self):
                return len(self.inner)

            def _kill(self, it):
                for i, b in enumerate(it):
                    if i == self.n and self.sent is None:
                        self.sent = time.time()
                        os.kill(os.getpid(), signal.SIGTERM)
                    yield b

            def __iter__(self):
                return self._kill(iter(self.inner))

            def iter_from(self, skip=0, epoch=0):
                return self._kill(self.inner.iter_from(skip, epoch))

        class PoisonedValid:
            def __iter__(self):
                raise AssertionError("validation ran during preemption")

        class EpochSpy(Callback):
            def __init__(self):
                self.ends = []

            def on_epoch_end(self, trainer, state, epoch, logs):
                self.ends.append(epoch)

        def trainer_():
            m, _ = build_network(lconf.networks["class"],
                                 {"conf": lconf, "device": dev, "seed": 0})
            return Trainer(m, split_strategy="auto", device=dev, seed=0)

        def bitwise(a, b, what):
            """Two state_to_host trees: every tensor equal bit for bit."""
            bad = mismatches(torch, a, b)
            require(not bad, f"long_runs {what}: not bitwise at {bad[:8]}")

        ds = Epochs(2, LR_["per_epoch"], seed=900_000)
        total = 2 * LR_["per_epoch"]
        tmp = tempfile.mkdtemp(prefix="long_runs_")
        pdir = os.path.join(tmp, "preempt")
        reset_counts()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            # run A: 2 epochs without a break
            ta = trainer_()
            a = ta.fit(ds, epochs=2, verbose=False)["state"]
            strategies = sorted(set(ta._split_dims.values()))
            drop = ta.model.user_tower.drop
            dropout = float(drop.p) if drop is not None else 0.0
            require(a.step == total, f"long_runs run A: step {a.step}")
            host_a = state_to_host(a)
            del ta, a
            # run B: SIGTERM while batch kill_at is drawn
            tb = trainer_()
            install_preemption_handler(tb)
            killer, spy = SigtermAt(ds, LR_["kill_at"]), EpochSpy()
            # step by step (scan_steps=1): the check reads the step at
            # which the preemption lands, which a stack of steps moves
            rb = tb.fit(killer, epochs=2, valid_ds=PoisonedValid(),
                        callbacks=[spy], preempt_dir=pdir, scan_steps=1,
                        verbose=False)
            returned = time.time()
            own_signals()
            step_b = rb["state"].step
            require(rb["preempted"] and 1 <= step_b <= LR_["kill_at"] + 1,
                    f"long_runs run B: preempted {rb['preempted']} at step "
                    f"{step_b}")
            require(spy.ends == [], f"long_runs run B: epoch-end callbacks "
                    f"ran for epochs {spy.ends}")
            ckpt = os.path.join(pdir, f"{step_b}.pt")
            require(os.listdir(pdir) == [f"{step_b}.pt"],
                    f"long_runs run B: {os.listdir(pdir)} in the preempt dir")
            signal_to_disk_s = os.stat(ckpt).st_mtime - killer.sent
            ckpt_mb = os.path.getsize(ckpt) / 1e6
            bitwise(state_to_host(rb["state"]), read_checkpoint(ckpt),
                    "the preempt checkpoint against the returned state")
            del tb, rb
            if not rehearse:
                torch.cuda.empty_cache()
            # run B resumed: a fresh model and Trainer restore the preempt
            # directory and finish the 2 epochs
            tc = trainer_()
            sc = tc.init_state(ds.epochs[0][0])
            sync()
            t0 = time.perf_counter()
            restore_checkpoint(pdir, sc)
            sync()
            restore_s = time.perf_counter() - t0
            require(sc.step == step_b, f"long_runs restore: step {sc.step}")
            rc = tc.fit(ds, epochs=2, state=sc, verbose=False)
            require(rc["state"].step == total and not rc["preempted"],
                    f"long_runs resumed run: step {rc['state'].step}")
            bitwise(host_a, state_to_host(rc["state"]),
                    "the resumed run against the uninterrupted one")
        finally:
            torch.use_deterministic_algorithms(False)
            own_signals()
        sync()
        launches["long_runs"] = read_counts()
        want = ["gather_rows"] + (["sparse_adagrad_apply"]
                                  if "sparse_set" in strategies else []) + \
            (["scatter_add_rows", "rowwise_adagrad_update"]
             if "dense" in strategies else [])
        require(rehearse or all(launches["long_runs"][k] > 0 for k in want),
                f"long_runs: {want} not all launched: {launches['long_runs']}")
        resume = {"strategies": strategies, "steps": total,
                  "preempted_at_step": step_b,
                  "signal_to_checkpoint_s": signal_to_disk_s,
                  "fit_return_after_signal_s": returned - killer.sent,
                  "checkpoint_mb": ckpt_mb, "restore_s": restore_s,
                  "bitwise": True, "deterministic_algorithms": True}
        del host_a

        # the profiler window over 8 steps of the restored model, each step
        # timed by the host clock after a synchronise
        pds = Epochs(1, LR_["profiled"], seed=950_000)
        step_ends = []
        real_step = tc._step

        def timed_step(state, batch):
            out = real_step(state, batch)
            sync()
            step_ends.append(time.perf_counter())
            return out
        tc._step = timed_step
        trace_dir = os.path.join(tmp, "trace")
        reset_counts()
        sync()
        t_start = time.perf_counter()
        # step by step (scan_steps=1): the window's checks count its steps'
        # events and time each step through Trainer._step
        rp = tc.fit(pds, epochs=1, state=rc["state"], resume_data=False,
                    profile_dir=trace_dir, profile_steps=LR_["profile"],
                    scan_steps=1, verbose=False)
        del tc._step
        p_counts = read_counts()
        traces = sorted(os.listdir(trace_dir))
        require(len(traces) == 1 and traces[0].endswith(".pt.trace.json"),
                f"long_runs profile: traces {traces}")
        # the port's trace reader: the card's events (the CPU's ops in the
        # rehearsal), and the window's steps from the host's Optimizer.step
        # annotations (the card's copies are not counted)
        try:
            trace = parse_trace(trace_dir, "cpu" if rehearse else "cuda")
        except ValueError as e:
            raise RuntimeError(f"long_runs profile: no device events in "
                               f"the trace ({e})") from e
        opt_steps = len(trace.step_spans_ms)
        lo, hi = LR_["profile"]
        require(opt_steps == hi - lo, f"long_runs profile: {opt_steps} "
                f"optimizer steps in the trace, want {hi - lo}")
        require(rehearse or trace.events > 0,
                "long_runs profile: no device events in the trace")
        ends = [t_start] + step_ends
        step_ms = [(ends[i + 1] - ends[i]) * 1e3 for i in range(len(step_ends))]
        # step i runs after the window check at n_steps == i: steps lo..hi-1
        # are traced; step lo's interval holds the trace's start, step hi's
        # its stop and the written file
        inside = [step_ms[i] for i in range(lo + 1, hi)]
        outside = [step_ms[i] for i in range(1, len(step_ms))
                   if not lo <= i <= hi]
        symbols = {n: s for n, (_, _, s) in LaunchRecorder.KERNELS.items()}
        listed = {}
        for name, sym in symbols.items():
            per_step = p_counts[name] / LR_["profiled"]
            listed[name] = {
                "launched_in_window": per_step * (hi - lo),
                "listed_in_trace": sum(op.count for op in trace.ops
                                       if sym in op.key)}
        profile = {"steps": LR_["profiled"], "window": [lo, hi],
                   "trace_mb": os.path.getsize(
                       os.path.join(trace_dir, traces[0])) / 1e6,
                   "device_events": trace.events,
                   "device_busy_ms": trace.device_total_ms,
                   "optimizer_steps": opt_steps,
                   "ms_per_step_in_window": float(np.median(inside)),
                   "ms_per_step_outside": float(np.median(outside)),
                   "ms_trace_start_step": step_ms[lo],
                   "ms_trace_stop_and_write_step": step_ms[hi],
                   "step_ms": step_ms, "port_kernels": listed}
        del rp, rc, sc, tc
        if not rehearse:
            torch.cuda.empty_cache()

        # the fine-tune CLI on records at the config's widths: cli/train
        # writes a checkpoint, cli/finetune promotes it to online (then
        # cli/predict reads it) or, under an interval that cannot hold,
        # raises PromotionBlocked and writes no online
        from recommendflow_tpu_torch.train.trainer import predict as predict_
        cli_s = {}
        rec = os.path.join(tmp, "rec")
        generate_records(lconf, rec, num_rows=LR_["cli_rows"], num_files=2,
                         seed=11)
        data = os.path.join(rec, "*.rfb")
        common = ["--data", data, "--batch_size", str(LR_["batch"]),
                  "--device", str(dev)]
        try:
            t0 = time.perf_counter()
            tres = train_cli.main([lpath, *common, "--train_mode", "test",
                                   "--epochs", "1", "--model_save_root",
                                   os.path.join(tmp, "run")])
            cli_s["train"] = time.perf_counter() - t0
        finally:
            own_signals()
        final = os.path.join(tmp, "run", "ckpt", "final.pt")
        require(os.path.isfile(final) and math.isfinite(
            tres["history"][-1]["loss"]), "long_runs: cli/train wrote no "
            "checkpoint")
        del tres
        ft_root = os.path.join(tmp, "ft")
        t0 = time.perf_counter()
        fres = ft_cli.main([lpath, *common, "--load_checkpoint", final,
                            "--model_save_root", ft_root, "--lr", "3e-4",
                            "--promotion_constraints",
                            "val_hit@10=[-1, inf)"])
        cli_s["finetune_promote"] = time.perf_counter() - t0
        online = os.path.join(ft_root, "online")
        require(fres["online"] is not None and os.listdir(online) ==
                [os.path.basename(fres["online"])],
                f"long_runs: finetune promoted {fres['online']}")
        t0 = time.perf_counter()
        outs = pred_cli.main([lpath, "--data", data, "--checkpoint", online,
                              "--out", os.path.join(tmp, "p.npz"),
                              "--device", str(dev)])
        cli_s["predict_online"] = time.perf_counter() - t0
        pds_, _ = make_dataset(lconf, data, 2048, shuffle=False,
                               drop_remainder=False)
        direct = predict_(fres["state"].model, pds_, dev)
        online_err = max(float(np.abs(outs[k] - direct[k]).max())
                         for k in ("user", "ad"))
        require(outs["user"].shape == (LR_["cli_rows"], 128)
                and online_err <= CLI_TOL,
                f"long_runs: cli/predict on online vs the finetuned model "
                f"{online_err}")
        base, fin = fres["base_logs"], fres["final_logs"]
        del fres, outs, direct
        if not rehearse:
            torch.cuda.empty_cache()
        blocked_root = os.path.join(tmp, "ft_blocked")
        t0 = time.perf_counter()
        try:
            ft_cli.main([lpath, *common, "--load_checkpoint", final,
                         "--model_save_root", blocked_root,
                         "--promotion_constraints", "val_hit@10=(-inf, -1)"])
            blocked = None
        except PromotionBlocked as e:
            blocked = str(e)
        cli_s["finetune_blocked"] = time.perf_counter() - t0
        require(blocked is not None and not os.path.exists(
            os.path.join(blocked_root, "online")),
            f"long_runs: the impossible interval did not block ({blocked})")
        shutil.rmtree(tmp, ignore_errors=True)
        if not rehearse:
            torch.cuda.empty_cache()
        log("long_runs", card=card, config=os.path.basename(lpath),
            batch=LR_["batch"], dropout=dropout, resume=resume,
            profile=profile,
            finetune={"cli_s": cli_s, "rows": LR_["cli_rows"],
                      "base_logs": base, "final_logs": fin,
                      "blocked": blocked},
            launches=launches["long_runs"])

    if "long_runs" in phases:
        long_runs_phase()

    def dispatch_phase():
        """Phase 13 (the module docstring); its names stay its own."""
        from recommendflow_tpu_torch.export import ServingModel, trace_model
        from recommendflow_tpu_torch.ops.cuda import launches as lc
        from recommendflow_tpu_torch.serving import EncodeServer, make_server
        from recommendflow_tpu_torch.train.checkpoint import (
            restore_checkpoint, state_to_host)
        from recommendflow_tpu_torch.train.optimizers import make_lr_schedule
        from recommendflow_tpu_torch.train.trainer import (
            current_learning_rate, eval_outputs, install_preemption_handler,
            make_optimizer)
        from recommendflow_tpu_torch.train.trainer import predict as predict_
        import threading
        import urllib.request
        DP = dict(batch=1024, rank_batch=2048, per_epoch=12, kill_at=10,
                  steps=16, chunk=8, text_batch=128, held=4, reps=10) \
            if not rehearse else \
            dict(batch=64, rank_batch=64, per_epoch=12, kill_at=10, steps=16,
                 chunk=8, text_batch=16, held=2, reps=2)
        bpath = BENCH_CONF if not rehearse else DEMO_CONF
        rpath = RANK_CONF if not rehearse else DEMO_RANK_CONF
        seeds = iter(range(1_100_000, 1_200_000))
        tmp = tempfile.mkdtemp(prefix="dispatch_")
        out = {"card": card, "deterministic_algorithms": True,
               "scan_steps_default": 8}

        def model_of(path, cls=None, **networks):
            conf = Configuration(path)
            if cls is not None:
                conf.networks["class"] = cls
            conf.networks.update(networks)
            m, _ = build_network(conf.networks["class"],
                                 {"conf": conf, "device": dev, "seed": 0})
            return m

        def batches_of(schema, rows, n, zipf=0.0):
            return [synthetic_batch(schema, rows, seed=next(seeds), zipf=zipf)
                    for _ in range(n)]

        def timed(run, n):
            """ms a step of run() (n steps), the host clock between two
            synchronises."""
            sync()
            t0 = time.perf_counter()
            run()
            sync()
            return (time.perf_counter() - t0) / n * 1e3

        # the port's kernels by the symbols the trace lists them under
        symbols = {"gather_rows": ("gather_rows_kernel",),
                   "scatter_add_rows": ("scatter_add_rows_kernel",),
                   "sparse_adagrad_apply": ("sparse_adagrad_kernel",),
                   "rowwise_adagrad_update": ("rowwise_adagrad_kernel",),
                   "flash_attention": ("flash_attention_kernel",
                                       "flash_attention_wide_kernel")}

        def profiled(run, n):
            """The device's idle share and busy ms a step over run() (n
            steps) under torch.profiler, and the device events of each of
            the port's kernels in the trace."""
            if rehearse:
                return None
            from torch.profiler import ProfilerActivity, profile
            from recommendflow_tpu_torch.tools.profile_slice import (
                _device_stats)
            from recommendflow_tpu_torch.utils.trace import profile_report
            sync()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run()
                sync()
                wall = time.perf_counter() - t0
            rep = profile_report(prof)      # the port's trace reader
            st = _device_stats(rep, wall, {})
            return {"idle_share": st["idle_share"],
                    "device_ms_per_step": st["device_busy_ms"] / n,
                    "wall_ms_per_step": wall / n * 1e3,
                    "device_events": st["device_events"],
                    "port_kernels_in_trace": {
                        kk: sum(op.count for op in rep.ops
                                if any(sym in op.key for sym in syms))
                        for kk, syms in symbols.items()}}

        def host_waits(run, n):
            """The host's waits for the card a step (CUDA's sync debug mode)."""
            if rehearse:
                return None
            from recommendflow_tpu_torch.tools.profile_slice import \
                count_syncs
            sync()
            return sum(count_syncs(run).values()) / n

        def path(tag, make, batches, n, lr_of=None, bitwise=True):
            """n steps eagerly (train_step) and as one stack (train_steps: the
            first eager, the second captured and replayed, the rest
            replayed) from one initial state (two trainers built alike): the
            states bitwise (unless `bitwise` is off: the run outside
            deterministic algorithms), the launches equal; then one stack
            more each way timed, profiled and under the sync debug mode.
            lr_of(i), when given, is the LR step i must read, on both
            paths."""
            te, tg = make(), make()
            se, sg = te.init_state(batches[0]), tg.init_state(batches[0])
            lrs = {"eager": [], "graphed": []}
            if lr_of is not None:
                for t, key in ((te, "eager"), (tg, "graphed")):
                    def host_step(state, real=t._host_step, key=key):
                        real(state)
                        lrs[key].append(current_learning_rate(state))
                    t._host_step = host_step
            sync()
            before = lc.snapshot()
            for b in batches[:n]:
                se, _ = te.train_step(se, b)
            sync()
            eager_counts = lc.difference(lc.snapshot(), before)
            before = lc.snapshot()
            sg, _ = tg.train_steps(sg, batches[:n])
            sync()
            graph_counts = lc.difference(lc.snapshot(), before)
            bad = mismatches(torch, state_to_host(se), state_to_host(sg)) \
                if bitwise else []
            require(not bad, f"dispatch {tag}: graphed steps differ from "
                    f"eager at {bad[:8]}")
            require(eager_counts == graph_counts, f"dispatch {tag}: launches "
                    f"eager {eager_counts} graphed {graph_counts}")
            if lr_of is not None:
                want = [lr_of(i) for i in range(n)]
                require(lrs["eager"][:n] == want == lrs["graphed"][:n],
                        f"dispatch {tag}: LRs {lrs} != {want}")
            extra = batches[n:n + DP["chunk"]]
            k = len(extra)
            st = {"eager": se, "graphed": sg}

            def eager_run():
                for b in extra:
                    st["eager"], _ = te.train_step(st["eager"], b)

            def graph_run():
                st["graphed"], _ = tg.train_steps(st["graphed"], extra)
            rec = {"steps": n, "bitwise": bitwise,
                   "launches_per_step": {
                       kk: v / n for kk, v in graph_counts.items()
                       if not isinstance(v, dict) and v},
                   "ms_per_step": {"eager": timed(eager_run, k),
                                   "graphed": timed(graph_run, k)},
                   "profile": {"eager": profiled(eager_run, k),
                               "graphed": profiled(graph_run, k)},
                   "host_waits_per_step": {"eager": host_waits(eager_run, k),
                                           "graphed": host_waits(graph_run,
                                                                 k)},
                   "graphs": tg.graph_stats().get("train", [])}
            if lr_of is not None:
                rec["lrs"] = lrs["graphed"][:n]
            require(rehearse or (rec["graphs"] and all(
                g["replays"] > 0 for g in rec["graphs"])),
                f"dispatch {tag}: no graph was replayed {rec['graphs']}")
            # the replays' launches observed: each of the port's kernels is
            # in the graphed run's trace as often as the counts say
            if not rehearse:
                traced = rec["profile"]["graphed"]["port_kernels_in_trace"]
                want = {kk: round(rec["launches_per_step"].get(kk, 0) * k)
                        for kk in symbols}
                require(traced == want, f"dispatch {tag}: the graphed run's "
                        f"trace lists {traced}, the counts say {want}")
            return rec, tg, st["graphed"]

        def eval_path(tag, trainer, state, held):
            """The eval forward through its graph (Trainer.predict) against
            the eager forward, bitwise; ms a batch each way."""
            model = state.model
            got = trainer.predict(state, held)
            model.eval()
            with torch.no_grad():
                eager = [model(to_device(b, dev)) for b in held]
            for kk, v in got.items():
                want = torch.cat([e[kk] for e in eager]).cpu().numpy()
                require(np.array_equal(v, want), f"dispatch {tag}: the "
                        f"graphed eval forward differs at {kk}")
            graph = trainer._eval_graph(model)

            def per_batch(g):
                def run():
                    with torch.no_grad():
                        for b in held:
                            eval_outputs(model, b, dev, g)
                return timed(run, len(held))

            def eager_predict():
                with torch.no_grad():
                    outs = [model(to_device(b, dev)) for b in held]
                return {kk: torch.cat([o[kk] for o in outs]).cpu().numpy()
                        for kk in outs[0]}

            def per_call(fn):
                """ms a call of fn() (median of 3)."""
                return float(np.median([timed(fn, 1) for _ in range(3)]))
            ms = {"eager": per_batch(None), "graphed": per_batch(graph)}
            # a short dataset: the module's predict captures a graph of its
            # own in each call; the trainer's predict replays its graph
            short = {"batches": len(held),
                     "ms_per_call": {
                         "eager": per_call(eager_predict),
                         "predict_own_graph": per_call(
                             lambda: predict_(model, held, dev)),
                         "trainer_predict": per_call(
                             lambda: trainer.predict(state, held))}}
            return {"bitwise": True, "ms_per_batch": ms,
                    "short_predict": short,
                    "graphs": trainer.graph_stats().get("eval", [])}

        def export_path(tag, model, held):
            """The model traced (trace_model) and served from memory on the
            card (ServingModel: its CUDA graph): predict bitwise against the
            program's fx module and the eager model; ms a batch of each,
            every output on the host. Returns (record, the ServingModel,
            the served batches)."""
            labels = [kk for kk in model.schema.label_names if kk in held[0]]
            consts = {kk: np.zeros_like(held[0][kk]) for kk in labels}
            served = [{kk: v for kk, v in b.items() if kk not in labels}
                      for b in held]
            model.eval()
            program, meta = trace_model(model, served[0], constants=consts)
            sync()
            t0 = time.perf_counter()
            sm = ServingModel(program, meta, dev)
            sync()
            build_s = time.perf_counter() - t0

            def eager(b):
                with torch.no_grad():
                    o = model(to_device({**b, **consts}, dev))
                return {kk: v.cpu().numpy() for kk, v in o.items()
                        if kk not in labels}

            def fx(b):
                with torch.no_grad():
                    o = sm._run(to_device(b, dev))
                return {kk: v.cpu().numpy() for kk, v in o.items()}
            for b in served:
                g, f, e = sm.predict(b), fx(b), eager(b)
                require(sorted(g) == sorted(f) == sorted(e) and all(
                    np.array_equal(g[kk], f[kk]) and
                    np.array_equal(g[kk], e[kk]) for kk in g),
                    f"dispatch {tag}: the served program differs from its "
                    f"fx run or the eager model")

            def per_batch(fn):
                def run():
                    for i in range(DP["reps"]):
                        fn(served[i % len(served)])
                return timed(run, DP["reps"])
            rec = {"bitwise": True, "graph_build_s": build_s,
                   "ms_per_batch": {"eager": per_batch(eager),
                                    "fx": per_batch(fx),
                                    "graphed": per_batch(sm.predict)},
                   "graphs": sm.graph.stats() if sm.graph else []}
            return rec, sm, served

        torch.use_deterministic_algorithms(True, warn_only=True)
        reset_counts()
        try:
            # (a) Dssm at bench_recall: fit at scan_steps 8 and 1, and a
            # SIGTERM inside a stack
            bconf = Configuration(bpath)
            bschema = compile_schema(bconf.features)

            class Epochs:
                def __init__(self, n_epochs, per_epoch):
                    self.epochs = [batches_of(bschema, DP["batch"], per_epoch)
                                   for _ in range(n_epochs)]

                def __len__(self):
                    return len(self.epochs[0])

                def __iter__(self):
                    return self.iter_from(0)

                def iter_from(self, skip=0, epoch=0):
                    return iter(self.epochs[epoch][skip:])

            ds = Epochs(2, DP["per_epoch"])
            total = 2 * DP["per_epoch"]

            def dssm_trainer(**kw):
                return Trainer(model_of(bpath), split_strategy="auto",
                               device=dev, seed=0, **kw)
            fits = {}
            for k in (8, 1):
                t = dssm_trainer()
                r = t.fit(ds, epochs=2, scan_steps=k, verbose=False)
                drop = t.model.user_tower.drop
                dropout = float(drop.p) if drop is not None else 0.0
                fits[k] = {"state": state_to_host(r["state"]),
                           "examples_per_s": [e["examples_per_sec"]
                                              for e in r["history"]],
                           "graphs": t.graph_stats().get("train", [])}
                require(r["state"].step == total, f"dispatch fit "
                        f"scan_steps={k}: step {r['state'].step}")
                del t, r
            bad = mismatches(torch, fits[8]["state"], fits[1]["state"])
            require(not bad, f"dispatch: fit(scan_steps=8) differs from "
                    f"scan_steps=1 at {bad[:8]}")
            require(rehearse or fits[8]["graphs"], "dispatch: fit "
                    "(scan_steps=8) replayed no graph")
            pdir = os.path.join(tmp, "preempt")
            t = dssm_trainer()
            real = t._host_step

            def host_step(state):
                if state.step == DP["kill_at"]:
                    os.kill(os.getpid(), signal.SIGTERM)
                real(state)
            t._host_step = host_step
            install_preemption_handler(t)
            try:
                r = t.fit(ds, epochs=2, scan_steps=8, preempt_dir=pdir,
                          verbose=False)
            finally:
                own_signals()
            stopped = r["state"].step
            require(r["preempted"] and stopped == DP["kill_at"] + 1,
                    f"dispatch preemption: preempted {r['preempted']} at "
                    f"step {stopped}, want {DP['kill_at'] + 1}")
            del t, r
            t = dssm_trainer()
            s = restore_checkpoint(pdir, t.init_state(ds.epochs[0][0]))
            r = t.fit(ds, epochs=2, state=s, scan_steps=8, verbose=False)
            bad = mismatches(torch, fits[8]["state"], state_to_host(r["state"]))
            require(not bad, f"dispatch: the run resumed from step {stopped} "
                    f"differs from the uninterrupted one at {bad[:8]}")
            out["dssm_fit"] = {
                "config": os.path.basename(bpath), "batch": DP["batch"],
                "dropout": dropout,
                "epochs": 2, "batches_per_epoch": DP["per_epoch"],
                "bitwise_scan8_vs_scan1": True,
                "examples_per_s": {"scan8": fits[8]["examples_per_s"],
                                   "scan1": fits[1]["examples_per_s"]},
                "graphs": fits[8]["graphs"],
                "preempted_at_step": stopped, "resumed_bitwise": True}
            del t, r, s, fits
            if not rehearse:
                torch.cuda.empty_cache()

            n, c = DP["steps"], DP["chunk"]
            paths = {}
            # the Dssm step's own numbers, its eval forward and its export
            rec, tg, sg = path("dssm", dssm_trainer,
                               batches_of(bschema, DP["batch"], c + c), c)
            paths["dssm/auto"] = dict(rec, split=dict(
                (f"dim{d}", s_) for d, s_ in tg._split_dims.items()))
            held = batches_of(bschema, DP["batch"], DP["held"])
            evals = {"dssm": eval_path("dssm", tg, sg, held)}
            exports = {}
            exports["Dssm"], _, _ = export_path("Dssm", sg.model, held)
            del tg, sg
            # (b) Dcn at bench_ranking on Zipf(1.2) ids, in each update mode
            rschema = compile_schema(Configuration(rpath).features)
            rb = batches_of(rschema, DP["rank_batch"], n + c, zipf=1.2)
            dcn = "recommendflow_tpu.models.ranking.dcn.Dcn"
            for tag, kw in (("split/sparse_set", dict(
                                split_strategy="sparse_set")),
                            ("split/dense", dict(split_strategy="dense")),
                            ("table_update/sparse", dict(
                                table_update="sparse")),
                            ("table_update/dense", dict(
                                table_update="dense"))):
                rec, tg, sg = path(
                    f"dcn {tag}", lambda kw=kw: Trainer(
                        model_of(rpath, dcn), device=dev, seed=0, **kw),
                    rb, n)
                paths[f"dcn/{tag}"] = rec
                if tag == "split/sparse_set":
                    rheld = batches_of(rschema, DP["rank_batch"], DP["held"])
                    evals["dcn"] = eval_path("dcn", tg, sg, rheld)
                    exports["Dcn"], dcn_sm, dcn_served = export_path(
                        "Dcn", sg.model, rheld)
                del tg, sg
                if not rehearse:
                    torch.cuda.empty_cache()
            # the same outside deterministic algorithms (the other phases'
            # setting): timed, not compared
            torch.use_deterministic_algorithms(False)
            rec, _, _ = path("dcn split/sparse_set, nondeterministic",
                             lambda: Trainer(model_of(rpath, dcn), device=dev,
                                             seed=0,
                                             split_strategy="sparse_set"),
                             rb, n, bitwise=False)
            paths["dcn/split/sparse_set/nondeterministic"] = rec
            torch.use_deterministic_algorithms(True, warn_only=True)
            if not rehearse:
                torch.cuda.empty_cache()
            # (c) Dssm under lamb with clip_norm, and the default Adam under
            # a cosine schedule with warmup: each step's LR exact
            db = batches_of(bschema, DP["batch"], c + c)
            rec, _, _ = path("dssm lamb", lambda: dssm_trainer(
                optimizer=make_optimizer(1e-3, "lamb", clip_norm=1.0)), db, c,
                lr_of=lambda i: 1e-3)
            paths["dssm/lamb_clip1"] = rec
            cosine = {"type": "cosine", "warmup_steps": 2, "decay_steps": 20}
            sched = make_lr_schedule(1e-3, **cosine)
            rec, _, _ = path("dssm cosine", lambda: dssm_trainer(
                lr_schedule=cosine), db, c, lr_of=sched)
            paths["dssm/cosine_warmup"] = rec
            if not rehearse:
                torch.cuda.empty_cache()
            # (d) TabTransformer at bench_ranking: a stack of 8
            rec, tg, sg = path("tabtransformer", lambda: Trainer(
                model_of(rpath, TAB_CLASS), device=dev, seed=0),
                batches_of(rschema, DP["rank_batch"], c + c), c)
            paths["tabtransformer"] = rec
            exports["TabTransformer"], _, _ = export_path(
                "TabTransformer", sg.model,
                batches_of(rschema, DP["rank_batch"], DP["held"]))
            del tg, sg
            if not rehearse:
                torch.cuda.empty_cache()
            # (e) SiameseEncoder on a BERT-Base at text_recall's shape
            bert = dict(enc_syn.BERT_BASE, vocab_size=30522) if not rehearse \
                else dict(enc_syn.BERT_BASE, vocab_size=30522, hidden_size=64,
                          num_hidden_layers=2, num_attention_heads=4,
                          intermediate_size=128)
            cfg_path, bin_path, _ = enc_syn.write_bert_files(
                os.path.join(tmp, "bert"), bert, seed=0)
            tconf = Configuration(text_conf)
            for f in tconf.features.features:
                if f.name in ("query_text", "title_text"):
                    f.max_len = TEXT_LEN
            tconf.networks["pretrained"] = {"encoder": {
                "config_path": cfg_path, "checkpoint_path": bin_path}}
            tschema = compile_schema(tconf.features)

            def siamese():
                m, _ = build_network(tconf.networks["class"],
                                     {"conf": tconf, "device": dev,
                                      "seed": 0})
                return Trainer(m, learning_rate=TEXT_LR, device=dev, seed=0)
            rec, tg, sg = path("siamese_encoder", siamese,
                               batches_of(tschema, DP["text_batch"], c + c), c)
            paths["siamese_encoder"] = rec
            del tg, sg
            if not rehearse:
                torch.cuda.empty_cache()
            # /predict with the served Dcn: bitwise its ServingModel.predict
            backend = EncodeServer(serving_model=dcn_sm)
            httpd = make_server(backend, host="127.0.0.1", port=0)
            server = threading.Thread(target=httpd.serve_forever, daemon=True)
            server.start()
            try:
                url = f"http://127.0.0.1:{httpd.server_address[1]}/predict"
                body = json.dumps({"batch": {kk: v.tolist() for kk, v in
                                             dcn_served[0].items()}}).encode()
                req = urllib.request.Request(url, data=body, method="POST")
                t0 = time.perf_counter()
                with urllib.request.urlopen(req, timeout=300) as resp:
                    got = json.loads(resp.read())
                predict_http_ms = (time.perf_counter() - t0) * 1e3
                ref = dcn_sm.predict(dcn_served[0])
                require(sorted(got) == sorted(ref) and all(
                    np.array_equal(np.asarray(got[kk], ref[kk].dtype),
                                   ref[kk]) for kk in ref),
                    "dispatch: /predict differs from the served Dcn")
            finally:
                httpd.shutdown()
                httpd.server_close()
                server.join(timeout=60)
            exports["Dcn"]["predict_http_bitwise"] = True
            exports["Dcn"]["predict_http_ms"] = predict_http_ms
            del dcn_sm, backend
        finally:
            torch.use_deterministic_algorithms(False)
            own_signals()
            shutil.rmtree(tmp, ignore_errors=True)
        sync()
        launches["dispatch"] = read_counts()
        require(rehearse or all(launches["dispatch"][kk] > 0 for kk in (
            "gather_rows", "scatter_add_rows", "sparse_adagrad_apply",
            "rowwise_adagrad_update", "flash_attention")),
            f"dispatch: a kernel of the path was not launched "
            f"{launches['dispatch']}")
        if not rehearse:
            torch.cuda.empty_cache()
        log("dispatch", **out, paths=paths, eval=evals, exports=exports,
            launches=launches["dispatch"])

    if "dispatch" in phases:
        dispatch_phase()

    # ----------------------------------------------------- 14. ranking_zoo
    if "ranking_zoo" in phases:
        zoo = {}
        for name, (path, kw, zpath) in ZOO.items():
            model, _ = build_network(path, {"conf": Configuration(zpath),
                                            "device": dev, "seed": 0, **kw})
            zb = [synthetic_batch(model.schema, 256, seed=600 + i)
                  for i in range(4)]
            reset_counts()
            state, losses = None, []
            for strategy, b in zip(("dense", "dense", "sparse_set"), zb):
                trainer = Trainer(model, split_strategy=strategy, device=dev,
                                  seed=0)
                if state is None:
                    state = trainer.init_state(b)
                else:
                    trainer.plan(b)
                state, m = trainer.train_step(state, b)
                losses.append(float(m["loss"]))
            counts = read_counts()
            require(all(math.isfinite(x) for x in losses), f"{name}: {losses}")
            require(all(counts[k] > 0 for k in (
                "gather_rows", "scatter_add_rows", "rowwise_adagrad_update",
                "sparse_adagrad_apply") + (("flash_attention",)
                                           if name in ATTENTION_ZOO else ()))
                    or rehearse, f"{name}: a kernel was not launched: {counts}")
            cpu_model = copy.deepcopy(model).to("cpu").eval()
            model.eval()
            with torch.no_grad():
                got = model(to_device(zb[3], dev))
                ref = cpu_model(to_device(zb[3], torch.device("cpu")))
            require(sorted(got) == sorted(ref), f"{name}: outputs {sorted(got)}")
            err = max(float((got[k].cpu() - ref[k]).abs().max()) for k in ref)
            require(err <= ZOO_CPU_TOL, f"{name}: eval on the card vs the CPU "
                    f"{err} > {ZOO_CPU_TOL}")
            zoo[name] = {"config": os.path.basename(zpath), "losses": losses,
                         "launches": counts, "outputs": sorted(got),
                         "cpu_vs_card": err}
            if name in GRAD_CHECKED:
                _, zoo[name]["grad_check"] = grad_check(model, zb[3], name)
            del model, cpu_model, state, trainer, got, ref
        log("ranking_zoo", batch=256, tolerance=ZOO_CPU_TOL, models=zoo)

    # ------------------------------------------------ 15. attention_ranking
    if "attention_ranking" in phases:
        from recommendflow_tpu_torch.models.common import field_shape
        aconf = Configuration(RANK_CONF if not rehearse else DEMO_RANK_CONF)
        aconf.networks["class"] = TAB_CLASS
        AR = dict(batch=2048, serve_batches=64, check_rows=256, warm=3,
                  steps=20, eval_batches=16, profile_steps=10) \
            if not rehearse else \
            dict(batch=64, serve_batches=4, check_rows=32, warm=1, steps=2,
                 eval_batches=2, profile_steps=0)
        model, _ = build_network(aconf.networks["class"],
                                 {"conf": aconf, "device": dev, "seed": 0})
        aschema = model.schema
        n_fields, fdim = field_shape(aschema)
        attn_shape = [AR["batch"], model.tab.block0.mha.num_heads, n_fields,
                      fdim // model.tab.block0.mha.num_heads]
        aseeds = iter(range(700_000, 800_000))

        def abatches(n):
            return [synthetic_batch(aschema, AR["batch"], seed=next(aseeds))
                    for _ in range(n)]

        if not rehearse:
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        serve = abatches(AR["serve_batches"])
        sync()
        t0 = time.perf_counter()
        out = predict(model, serve, dev)
        sync()
        serve_s = time.perf_counter() - t0
        n_rows = AR["batch"] * AR["serve_batches"]
        score = out["score"]
        require(score.shape == (n_rows,) and bool(np.isfinite(score).all())
                and bool(((score > 0) & (score < 1)).all()),
                f"TabTransformer scores: shape {score.shape}, "
                f"range [{score.min()}, {score.max()}]")
        serve_counts = read_counts()
        require(all(serve_counts[k] > 0 for k in (
            "gather_rows", "flash_attention")) or rehearse,
                f"a kernel was not launched serving TabTransformer: "
                f"{serve_counts}")
        few = {k: v[:AR["check_rows"]] for k, v in serve[0].items()}
        del serve, out
        # training with the planner, ending with the AUC on held-out batches
        eval_ds = abatches(AR["eval_batches"])
        state, per_run = None, {}
        for name, n in (("warm", AR["warm"]), ("auto", AR["steps"])):
            trainer = Trainer(model, device=dev, seed=0)
            res = trainer.fit(abatches(n), valid_ds=eval_ds, state=state,
                              resume_data=False, verbose=False)
            state, logs = res["state"], res["history"][-1]
            require(math.isfinite(logs["loss"]) and
                    0.0 <= logs.get("val_auc", -1.0) <= 1.0,
                    f"TabTransformer run {name}: {logs}")
            per_run[name] = {
                "steps": n,
                "split": {f"dim{d}": s_ for d, s_ in trainer._split_dims.items()},
                "loss": logs["loss"], "val_auc": logs["val_auc"],
                "examples_per_s": logs["examples_per_sec"],
                "ms_per_step": AR["batch"] / logs["examples_per_sec"] * 1e3}
        sync()
        launches["attention_ranking"] = read_counts()
        planned = set(trainer._split_dims.values())
        need = ("gather_rows", "flash_attention") + \
            (("sparse_adagrad_apply",) if "sparse_set" in planned else ()) + \
            (("scatter_add_rows", "rowwise_adagrad_update")
             if "dense" in planned else ())
        require(all(launches["attention_ranking"][k] > 0 for k in need)
                or rehearse, f"a kernel was not launched on the TabTransformer "
                f"path: {launches['attention_ranking']}")
        # the trained weights on the CPU (TF32 off on the card)
        model.eval()
        cpu_model = copy.deepcopy(model).to("cpu")
        with torch.no_grad():
            card_logit = model(to_device(few, dev))["logit"].cpu()
            cpu_logit = cpu_model(to_device(few, torch.device("cpu")))["logit"]
        cpu_err = float((card_logit - cpu_logit).abs().max())
        del cpu_model
        require(cpu_err <= RANK_CPU_TOL, f"TabTransformer logits on the card "
                f"vs the CPU: {cpu_err} > {RANK_CPU_TOL}")
        # the gradient check, one batch at dropout 0
        card_model, grads = grad_check(model, abatches(1)[0],
                                 "TabTransformer (attention_ranking)")
        q_grad = float(card_model.tab.block0.mha.q.weight.grad.abs().max())
        require(q_grad > 0, "tab.block0.mha.q.weight has no gradient on the "
                "card")
        grads["tab.block0.mha.q.weight_grad_max"] = q_grad
        del card_model
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 if not rehearse \
            else None
        # where a step's time goes: 10 steps with the planner's strategy
        # under torch.profiler
        profiled = None
        if not rehearse:
            from recommendflow_tpu_torch.tools.profile_slice import (
                profile_training)
            profiled = {st["mode"]: {k: st[k] for k in (
                "per_step_wall_ms", "per_step_device_ms", "idle_share",
                "host_syncs_per_step", "launches_per_step", "top_ms",
                "port_kernels")}
                for st in profile_training(
                    model, dev, AR["profile_steps"], batch=AR["batch"],
                    modes=tuple(("split", s_) for s_ in sorted(planned)))}
        log("attention_ranking", config=os.path.basename(RANK_CONF)
            if not rehearse else os.path.basename(DEMO_RANK_CONF),
            model="TabTransformer", table=list(table_params(model)[fdim].shape),
            fields=n_fields, attention_shape=attn_shape, batch=AR["batch"],
            serve_rows=n_rows,
            serve_ms_per_batch=serve_s / AR["serve_batches"] * 1e3,
            serve_launches=serve_counts, runs=per_run,
            launches=launches["attention_ranking"],
            cpu_vs_card_logit=cpu_err, cpu_tolerance=RANK_CPU_TOL,
            grad_check=grads, profiled=profiled, peak_mem_gb=peak_gb)
        del model, state, trainer, eval_ds
        if not rehearse:
            torch.cuda.empty_cache()

    # ------------------------------------------------------ 16. text_recall
    tr_mask = tr_fa = None
    if "text_recall" in phases:
        from recommendflow_tpu_torch.data.pipeline import make_dataset
        from recommendflow_tpu_torch.encoder.pretrained import (
            bert_params_to_flax, load_bert_checkpoint)
        from recommendflow_tpu_torch.interop import variables_from_jax
        from recommendflow_tpu_torch.retrieval.eval import make_recall_evaluator
        from recommendflow_tpu_torch.train.callbacks import EvalCallback
        # BERT-Base with the English release's vocabulary; a two-layer toy
        # of it in the rehearsal
        bert = dict(enc_syn.BERT_BASE, vocab_size=30522)
        TR = dict(bert=bert, batch=128, warm=3, steps=20, eval_batches=16,
                  check_rows=16, profile_steps=10) if not rehearse else \
            dict(bert=dict(bert, hidden_size=64, num_hidden_layers=2,
                           num_attention_heads=4, intermediate_size=128),
                 batch=16, warm=1, steps=2, eval_batches=2, check_rows=8,
                 profile_steps=0)
        tconf = Configuration(text_conf)
        for f in tconf.features.features:
            if f.name in ("query_text", "title_text"):
                f.max_len = TEXT_LEN
        tr_dir = os.path.join(enc_tmp.name, "text_recall")
        cfg_path, bin_path, _ = enc_syn.write_bert_files(
            os.path.join(tr_dir, "bert"), TR["bert"], seed=0)
        tconf.networks["pretrained"] = {"encoder": {
            "config_path": cfg_path, "checkpoint_path": bin_path}}
        n_tb = TR["warm"] + TR["steps"] + TR["eval_batches"]
        generate_records(tconf, os.path.join(tr_dir, "rec"),
                         num_rows=n_tb * TR["batch"], num_files=4, seed=3)
        tds, _ = make_dataset(tconf, os.path.join(tr_dir, "rec", "*.rfb"),
                              TR["batch"], shuffle=False)
        tbatches = list(tds)
        require(len(tbatches) == n_tb and tbatches[0]["query_text"].shape ==
                (TR["batch"], TEXT_LEN) and "query_text:seg" in tbatches[0],
                f"text_recall records: {len(tbatches)} batches")
        warm_b = tbatches[:TR["warm"]]
        run_b = tbatches[TR["warm"]:TR["warm"] + TR["steps"]]
        eval_b = tbatches[TR["warm"] + TR["steps"]:]
        tr_mask = torch.from_numpy(tbatches[0]["query_text"] > 0).to(dev)
        model, _ = build_network(tconf.networks["class"],
                                 {"conf": tconf, "device": dev, "seed": 0})
        enc = model.encoder
        attn_shape = [TR["batch"], enc.num_heads, TEXT_LEN,
                      enc.model_dim // enc.num_heads]
        if not rehearse:
            torch.cuda.reset_peak_memory_stats()
        # Adam at BERT's fine-tuning rate (Devlin et al. 2019, appendix A.3:
        # 5e-5, 3e-5 or 2e-5): at the trainer's default 1e-3 the fine-tune
        # collapses within the 23 steps: on the check's 16 rows the loss
        # is the uniform answer's (ln 16 x the positives' share) and the
        # largest gradient ~1e-7
        trainer = Trainer(model, learning_rate=TEXT_LR, device=dev, seed=0)
        state = trainer.init_state(tbatches[0])
        # the graft: the encoder holds the checkpoint's converted tree
        want = variables_from_jax({"params": bert_params_to_flax(
            load_bert_checkpoint(bin_path),
            num_layers=TR["bert"]["num_hidden_layers"], max_len=TEXT_LEN,
            num_heads=TR["bert"]["num_attention_heads"])})
        got = enc.state_dict()
        require(sorted(got) == sorted(want) and all(
            torch.equal(got[k].cpu().view(torch.int32),
                        want[k].view(torch.int32)) for k in want),
                "text_recall: the grafted encoder differs from the checkpoint")
        require(state.table_acc == {} and not table_params(model),
                "text_recall: SiameseEncoder should own no table")
        # the gradient check on the grafted weights, and after training below
        few = {k: v[:TR["check_rows"]] for k, v in eval_b[0].items()}
        _, grads_grafted = grad_check(model, few,
                                      "SiameseEncoder (text_recall, grafted)")
        reset_counts()
        per_run = {}
        for name, data, cbs in (
                ("warm", warm_b, []),
                ("train", run_b, [EvalCallback(make_recall_evaluator(
                    eval_b, topk_list=[10, 50]))])):
            res = trainer.fit(data, state=state, callbacks=cbs,
                              resume_data=False, verbose=False)
            state, logs = res["state"], res["history"][-1]
            per_run[name] = {
                "steps": len(data), "loss": logs["loss"],
                "examples_per_s": logs["examples_per_sec"],
                "ms_per_step": TR["batch"] / logs["examples_per_sec"] * 1e3}
        recall = {k: v for k, v in logs.items() if k.startswith("val_")}
        require(all(math.isfinite(r["loss"]) for r in per_run.values()),
                f"text_recall losses {per_run}")
        require(bool(recall) and all(0.0 <= v <= 1.0 for k, v in recall.items()
                                     if k.startswith("val_hit@")),
                f"text_recall recall@K {recall}")
        sync()
        t0 = time.perf_counter()
        out = predict(model, eval_b, dev)
        sync()
        predict_s = time.perf_counter() - t0
        launches["text_recall"] = read_counts()
        # kernel 6 runs on this path; the evaluation's exact search takes
        # grouped_score_max only from 262,144 items (_HIER_MIN_ITEMS, as the
        # JAX package picks its path), and these records give ~2,000
        require(launches["text_recall"]["flash_attention"] > 0 or rehearse,
                f"flash_attention was not launched on the text_recall path: "
                f"{launches['text_recall']}")
        n_rows = TR["batch"] * TR["eval_batches"]
        for k in ("user", "ad"):
            require(out[k].shape == (n_rows, 64) and bool(
                np.isfinite(out[k]).all()) and bool(np.allclose(
                    np.linalg.norm(out[k], axis=1), 1.0, atol=1e-4)),
                    f"text_recall {k} vectors {out[k].shape}")
        # the trained weights on the CPU (eval mode: no dropout)
        model.eval()
        cpu_model = copy.deepcopy(model).to("cpu")
        with torch.no_grad():
            card_v = model(to_device(few, dev))
            cpu_v = cpu_model(to_device(few, torch.device("cpu")))
        vec_err = max(float((card_v[k].cpu() - cpu_v[k]).abs().max())
                      for k in ("user", "ad"))
        del cpu_model, card_v, cpu_v
        require(vec_err <= TEXT_CPU_TOL, f"text_recall vectors on the card vs "
                f"the CPU: {vec_err} > {TEXT_CPU_TOL}")
        card_model, grads = grad_check(model, few,
                                       "SiameseEncoder (text_recall, trained)")
        for leaf in ("encoder.tok_emb.weight", "encoder.block0.mha.q.weight"):
            g_max = float(card_model.get_parameter(leaf).grad.abs().max())
            require(g_max > 0, f"text_recall: {leaf} has no gradient on the "
                    f"card")
            grads[f"{leaf}_grad_max"] = g_max
        del card_model
        # kernel 6 at this path's shape on the layer inputs of one
        # evaluation batch (12 layers x 2 towers, the batch's own masks):
        # forward and gradient against the plain version
        seen = []
        real = attn_mod.flash_attention

        def spy(q_, k_, v_, m_=None):
            seen.append((q_.detach(), k_.detach(), v_.detach(), m_))
            return real(q_, k_, v_, m_)
        attn_mod.flash_attention = spy
        try:
            with torch.no_grad():
                model.eval()(to_device(eval_b[0], dev))
        finally:
            attn_mod.flash_attention = real
        require(len(seen) == 2 * enc.num_layers and all(
            list(q_.shape) == attn_shape and m_ is not None
            for q_, _, _, m_ in seen), f"text_recall: kernel 6 inputs "
            f"{[tuple(x[0].shape) for x in seen]}")
        tr_fa = {"inputs": len(seen), "max_abs_err": 0.0,
                 "grad_rel_err": 0.0, "tolerance": FA_F32_TOL,
                 "grad_tolerance": FA_GRAD_TOL,
                 "valid_key_share": [float(seen[0][3].float().mean()),
                                     float(seen[-1][3].float().mean())]}
        for i, (q_, k_, v_, m_) in enumerate(seen):
            got_ = k_fa.flash_attention(q_, k_, v_, m_)
            ref_ = k_fa.flash_attention_plain(q_, k_, v_, m_)
            sync()
            tr_fa["max_abs_err"] = max(tr_fa["max_abs_err"],
                                       float((got_ - ref_).abs().max()))
            go = torch.randn(q_.shape, generator=gen, device=dev)
            tr_fa["grad_rel_err"] = max(tr_fa["grad_rel_err"], *fa_grad_rel(
                q_, k_, v_, m_, go, f"text_recall layer input {i}").values())
        del seen, got_, ref_, go
        require(tr_fa["max_abs_err"] <= FA_F32_TOL, f"flash_attention at "
                f"text_recall's layer inputs: {tr_fa['max_abs_err']} > "
                f"{FA_F32_TOL}")
        errs["flash_attention"] = max(errs.get("flash_attention") or 0.0,
                                      tr_fa["max_abs_err"])
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 if not rehearse \
            else None
        # where a step's time goes: 10 steps of the records' batches under
        # torch.profiler (its trainer keeps the trained weights)
        profiled = None
        if not rehearse:
            from recommendflow_tpu_torch.tools.profile_slice import (
                profile_training)
            profiled = {st["mode"]: {k: st[k] for k in (
                "per_step_wall_ms", "per_step_device_ms", "idle_share",
                "host_syncs_per_step", "launches_per_step", "top_ms",
                "port_kernels")}
                for st in profile_training(
                    model, dev, TR["profile_steps"], batch=TR["batch"],
                    modes=(("dense", "dense"),),
                    batches=run_b + warm_b)}
        log("text_recall", config=os.path.basename(TEXT_CONF),
            model="SiameseEncoder", encoder={
                "layers": enc.num_layers, "width": enc.model_dim,
                "heads": enc.num_heads, "vocab": enc.vocab_size,
                "max_len": TEXT_LEN}, attention_shape=attn_shape,
            valid_key_share=float(tr_mask.float().mean()), batch=TR["batch"],
            graft_bitwise=True, runs=per_run, recall=recall,
            predict_rows=n_rows, eval_corpus_items=recall.get("val_num_items"),
            predict_ms_per_batch=predict_s / TR["eval_batches"] * 1e3,
            launches=launches["text_recall"], cpu_vs_card=vec_err,
            cpu_tolerance=TEXT_CPU_TOL, grad_check_grafted=grads_grafted,
            grad_check=grads, flash_attention_check=tr_fa, profiled=profiled,
            peak_mem_gb=peak_gb)
        del model, state, trainer, tbatches, warm_b, run_b, eval_b, out
        if not rehearse:
            torch.cuda.empty_cache()

    # ---------------------------------------------------------- 17. simbert
    if "simbert" in phases:
        from recommendflow_tpu_torch.encoder.generators import simbert_batches
        from recommendflow_tpu_torch.encoder.pretrained import (
            load_pretrained_text_encoder)
        from recommendflow_tpu_torch.encoder.simbert import simbert_loss
        from recommendflow_tpu_torch.tools.profile_slice import _device_stats
        from recommendflow_tpu_torch.utils.trace import profile_report
        from recommendflow_tpu_torch.train.optimizers import make_optimizer
        from recommendflow_tpu_torch.train.trainer import step_seed
        # [128, 128] token rows (64 pairs, both orders) on BERT-Base; the
        # encoder's two-layer toy in the rehearsal
        SB = dict(batch=128, max_len=64, steps=20, check_rows=16,
                  profile_steps=5, lr=SIMBERT_LR) if not rehearse else \
            dict(batch=16, max_len=16, steps=6, check_rows=8, profile_steps=0,
                 lr=1e-3)
        if bert_files is None:
            bert_files = enc_syn.write_bert_files(enc_tmp.name, cfg, seed=0)
        sb_tok = Tokenizer(bert_files[2])
        sb_texts = enc_syn.make_texts(SB["batch"], seed=5)
        pairs = list(zip(sb_texts[0::2], sb_texts[1::2]))
        sb_np = next(simbert_batches(pairs, sb_tok, SB["batch"], SB["max_len"],
                                     shuffle=False))
        width = 2 * SB["max_len"]
        require(sb_np["tok"].shape == (SB["batch"], width),
                f"simbert batch {sb_np['tok'].shape}")
        sb = to_device(sb_np, dev)
        model, _ = load_pretrained_text_encoder(bert_files[0], bert_files[1],
                                                max_len=width, device=dev)
        vocab_size = model.vocab_size
        reset_counts()
        # (a) causality on the card: a late segment-1 token changes no
        # earlier position of its row, bit for bit (deterministic GEMMs)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            model.eval()
            seg1 = ((sb["seg"][0] == 1) & (sb["tok"][0] > 0)).nonzero()
            p_late = int(seg1[-2])                 # before the final [SEP]
            tok2 = sb["tok"].clone()
            tok2[0, p_late] = (int(tok2[0, p_late]) + 7) % (vocab_size - 5) + 5
            with torch.no_grad():
                h1 = model(sb["tok"], sb["seg"], seq2seq=True,
                           return_sequence=True)
                h2 = model(tok2, sb["seg"], seq2seq=True, return_sequence=True)
            causal = {"row": 0, "changed_position": p_late,
                      "earlier_bitwise": bool(torch.equal(h1[0, :p_late],
                                                          h2[0, :p_late])),
                      "other_rows_bitwise": bool(torch.equal(h1[1:], h2[1:])),
                      "changed_moved": float((h1[0, p_late] - h2[0, p_late]
                                              ).abs().max())}
        finally:
            torch.use_deterministic_algorithms(False)
        require(causal["earlier_bitwise"] and causal["changed_moved"] > 0,
                f"simbert: the UniLM mask leaks on the card: {causal}")
        del h1, h2, tok2

        class SimbertObjective(torch.nn.Module):
            """simbert_loss as a model that returns (loss, aux) from a
            batch, as grad_check drives one."""

            def __init__(self, encoder):
                super().__init__()
                self.encoder = encoder

            def forward(self, batch):
                return simbert_loss(self.encoder, batch)

        # (b) dropout 0: the loss, both parts and every gradient on the card
        # against the CPU (f32 and f64) on a sub-batch of check_rows rows
        # (a full [128, 128] batch costs BERT-Base minutes on the CPU)
        few = {k: v[:SB["check_rows"]] for k, v in sb_np.items()}
        objective = SimbertObjective(model)
        parts = {}
        cpu_enc = copy.deepcopy(model).to("cpu").eval()
        with torch.no_grad():
            for name, m_, d_ in (("card", model, dev),
                                 ("cpu", cpu_enc, torch.device("cpu"))):
                loss_, aux_ = simbert_loss(m_, to_device(few, d_))
                parts[name] = {"loss": float(loss_), **{
                    k: float(v) for k, v in aux_.items()}}
        del cpu_enc
        part_err = max(abs(parts["card"][k] - parts["cpu"][k]) /
                       abs(parts["cpu"][k]) for k in parts["cpu"])
        require(part_err <= SIMBERT_LOSS_RTOL, f"simbert losses on the card "
                f"vs the CPU: {parts} ({part_err} > {SIMBERT_LOSS_RTOL})")
        card_obj, grads = grad_check(objective, few, "SimBERT (BERT-Base)")
        del card_obj
        # (c) Adam on one repeated batch at the checkpoint's dropout (0.1),
        # each step's dropout drawn from a generator seeded explicitly
        model.train()
        opt = make_optimizer(SB["lr"], "adam").build(
            list(model.named_parameters()))
        if not rehearse:
            sync()
            torch.cuda.reset_peak_memory_stats()

        def sb_step(i):
            for p_ in model.parameters():
                p_.grad = None
            loss_, aux_ = simbert_loss(model, sb, seed=step_seed(0, i))
            loss_.backward()
            opt.step()
            return loss_.detach(), {k: v.detach() for k, v in aux_.items()}

        losses, t_first = [], None
        t0 = time.perf_counter()
        for i in range(SB["steps"]):
            losses.append(sb_step(i))
            if i == 0:
                sync()
                t_first = time.perf_counter()
        sync()
        ms_step = (time.perf_counter() - t_first) / (SB["steps"] - 1) * 1e3
        first_ms = (t_first - t0) * 1e3
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 if not rehearse \
            else None
        curve = [float(l_) for l_, _ in losses]
        lm_curve = [float(a_["lm_loss"]) for _, a_ in losses]
        sim_curve = [float(a_["sim_loss"]) for _, a_ in losses]
        require(all(math.isfinite(x) for x in curve + lm_curve + sim_curve),
                f"simbert losses {curve}")
        require(curve[-1] < curve[0], f"simbert: the loss did not fall over "
                f"{SB['steps']} steps: {curve}")
        launches["simbert"] = read_counts()
        # (d) no seq2seq pass reaches kernel 6 (the UniLM mask is full)
        require(launches["simbert"]["flash_attention"] == 0,
                f"simbert: kernel 6 launched on a full mask "
                f"{launches['simbert']}")
        # where a step's time goes: a few more steps under torch.profiler,
        # device time by op class from the ops' own shapes
        profiled = None
        if SB["profile_steps"]:
            sync()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU,
                                torch.profiler.ProfilerActivity.CUDA],
                    record_shapes=True) as prof:
                t0 = time.perf_counter()
                for i in range(SB["profile_steps"]):
                    sb_step(SB["steps"] + i)
                sync()
                wall = time.perf_counter() - t0
            stats = _device_stats(profile_report(prof), wall, {})
            classes = op_classes(prof, vocab_size, width)
            n_ = SB["profile_steps"]
            profiled = {"per_step_wall_ms": stats["wall_ms"] / n_,
                        "per_step_device_ms": stats["device_busy_ms"] / n_,
                        "idle_share": stats["idle_share"],
                        "device_ms_per_step_by_class": {
                            k: v / n_ for k, v in classes.items()},
                        "top_ms": stats["top_ms"]}
        log("simbert", encoder={"layers": model.num_layers,
                                "width": model.model_dim,
                                "heads": model.num_heads, "vocab": vocab_size,
                                "max_len": width},
            batch=list(sb_np["tok"].shape),
            segment1_tokens=int(((sb["seg"] == 1) & (sb["tok"] > 0)).sum()),
            causality=causal, cpu_check_rows=SB["check_rows"],
            losses_card_vs_cpu=parts, loss_rel_err=part_err,
            loss_tolerance=SIMBERT_LOSS_RTOL, grad_check=grads,
            steps=SB["steps"], lr=SB["lr"], loss_curve=curve,
            lm_loss_curve=lm_curve, sim_loss_curve=sim_curve,
            ms_per_step=ms_step, first_step_ms=first_ms,
            launches=launches["simbert"], profiled=profiled,
            peak_mem_gb=peak_gb,
            lm_logits_gb=SB["batch"] * (width - 1) * vocab_size * 4 / 1e9)
        del model, opt, objective, sb, losses
        if not rehearse:
            torch.cuda.empty_cache()

    # ----------------------------------------------------- 18. matching_zoo
    def tower_table_grads_ms(model, batch):
        """CUDA-event time of what a dense-path step spends on the table
        gradients of a model that embeds each tower in its own pass: per
        tower and dim group one take_rows and its backward (the sort, the
        duplicate sum, a zeroed table, scatter_add_rows)."""
        from recommendflow_tpu_torch.ops.embedding import take_rows
        b_dev = to_device(batch, dev)
        work = []
        for tower in ("user", "ad"):
            for d, gids in fused_group_ids(model.schema, b_dev,
                                           tower=tower).items():
                tbl = getattr(model.embedder, f"table_dim{d}").view(-1, d)
                ids = gids.reshape(-1).to(torch.int32).contiguous()
                work.append((tbl, ids, torch.randn(
                    (ids.numel(), d), generator=gen, device=dev)))

        def passes(i):
            for tbl, ids, g in work:
                torch.autograd.grad(take_rows(tbl, ids), tbl, g)
        return Timer(torch, 20).median_ms(passes)

    if "matching_zoo" in phases:
        image_conf = os.path.join(enc_tmp.name, "image.yaml")
        with open(image_conf, "w") as f:
            f.write(IMAGE_YAML)
        mz_batch = 256 if not rehearse else 32
        zoo = {}
        for name, (path, kw, zpath, nets, need, checked) in \
                MATCHING_ZOO.items():
            zpath = {"image": image_conf, TEXT_CONF: text_conf}.get(zpath, zpath)
            zconf = Configuration(zpath)
            zconf.networks.update(nets)
            model, _ = build_network(path, {"conf": zconf, "device": dev,
                                            "seed": 0, **kw})
            zb = [synthetic_batch(model.schema, mz_batch, seed=900 + i)
                  for i in range(4)]
            grads = {}
            # behind Dssm's BatchNorm the ViT head's bias and its last
            # LayerNorm's bias only shift features the batch mean removes,
            # so their exact gradient is 0
            zero = ("vit_item_img.head.bias", "vit_item_img.block1.ln2.bias") \
                if name == "Dssm-vit" else ()
            if checked:
                # on the built weights, and after the three steps below
                _, grads["built"] = grad_check(model, zb[3], f"{name} (built)",
                                               exact_zero=zero)
            reset_counts()
            state, losses = None, []
            for strategy, b in zip(("dense", "dense", "sparse_set"), zb):
                trainer = Trainer(model, split_strategy=strategy, device=dev,
                                  seed=0)
                if state is None:
                    state = trainer.init_state(b)
                else:
                    trainer.plan(b)
                state, m = trainer.train_step(state, b)
                losses.append(float(m["loss"]))
            counts = read_counts()
            require(all(math.isfinite(x) for x in losses), f"{name}: {losses}")
            require(all(counts[k] > 0 for k in need) or rehearse,
                    f"{name}: a kernel was not launched: {counts}")
            if checked:
                _, grads["trained"] = grad_check(
                    model, zb[3], f"{name} (three steps)", exact_zero=zero)
            cpu_model = copy.deepcopy(model).to("cpu").eval()
            model.eval()
            with torch.no_grad():
                got = model(to_device(zb[3], dev))
                ref = cpu_model(to_device(zb[3], torch.device("cpu")))
            require(sorted(got) == sorted(ref), f"{name}: outputs {sorted(got)}")
            err = max(float((got[k].cpu() - ref[k]).abs().max()) for k in ref)
            require(err <= ZOO_CPU_TOL, f"{name}: eval on the card vs the CPU "
                    f"{err} > {ZOO_CPU_TOL}")
            zoo[name] = {"config": os.path.basename(zpath), "losses": losses,
                "split": {f"dim{d}": s_ for d, s_ in trainer._split_dims.items()},
                "launches": counts, "outputs": sorted(got), "cpu_vs_card": err}
            if name == "Que2Search-recall":
                zoo[name]["scatter_add_rows_per_step"] = \
                    counts["scatter_add_rows"] / 3
                if not rehearse:
                    zoo[name]["table_grads_ms_per_step"] = \
                        tower_table_grads_ms(model, zb[0])
            if grads:
                zoo[name]["grad_check"] = grads
            del model, cpu_model, state, trainer, got, ref
        log("matching_zoo", batch=mz_batch, tolerance=ZOO_CPU_TOL, models=zoo)

    # -------------------------------------------------- 19. export_serve
    export_serve = None
    if "export_serve" in phases:
        import threading
        import urllib.error
        import urllib.request
        from recommendflow_tpu_torch.export import (ServingModel,
                                                    custom_op_nodes,
                                                    save_export, trace_model)
        from recommendflow_tpu_torch.serving import EncodeServer, make_server
        XS = dict(held=4, clients=4, latency_reps=10, reps=10) \
            if not rehearse else dict(held=2, clients=2, latency_reps=2,
                                      reps=2)
        # name -> (config, class (None: the config's), batch rows); the
        # demo configs in the rehearsal
        xcases = {
            "Dcn": (RANK_CONF if not rehearse else DEMO_RANK_CONF,
                    "recommendflow_tpu.models.ranking.dcn.Dcn",
                    2048 if not rehearse else 64),
            "TabTransformer": (RANK_CONF if not rehearse else DEMO_RANK_CONF,
                               TAB_CLASS, 2048 if not rehearse else 64),
            "Dssm": (BENCH_CONF if not rehearse else DEMO_CONF, None,
                     1024 if not rehearse else 64)}
        xdir = tempfile.TemporaryDirectory(prefix="chip_smoke_export_")
        xseeds = iter(range(900_000, 1_000_000))
        export_serve, x_launches = {}, {}
        dcn_serving = dcn_path = dcn_held = dcn_schema = None

        def numpy_out(out):
            return {k: v.cpu().numpy() for k, v in out.items()}

        def per_batch_ms(fn, held):
            """Mean wall ms of fn(batch) over reps calls cycling through the
            held batches, each call ending on the host with numpy."""
            fn(held[0])
            sync()
            t0 = time.perf_counter()
            for i in range(XS["reps"]):
                fn(held[i % len(held)])
            return (time.perf_counter() - t0) / XS["reps"] * 1e3

        try:
            for name, (conf_path, cls, rows) in xcases.items():
                xconf = Configuration(conf_path)
                if cls is not None:
                    xconf.networks["class"] = cls
                model, _ = build_network(xconf.networks["class"],
                                         {"conf": xconf, "device": dev,
                                          "seed": 0})
                model.eval()
                xschema = model.schema
                held = [synthetic_batch(xschema, rows, seed=next(xseeds))
                        for _ in range(XS["held"])]
                labels = [k for k in xschema.label_names if k in held[0]]
                consts = {k: np.zeros_like(held[0][k]) for k in labels}
                served = [{k: v for k, v in b.items() if k not in labels}
                          for b in held]

                def eager(batch, model=model, consts=consts):
                    with torch.no_grad():
                        return numpy_out(model(to_device({**batch, **consts},
                                                         dev)))

                want = [eager(b) for b in served]
                sync()
                t0 = time.perf_counter()
                program, meta = trace_model(model, served[0], constants=consts)
                sync()
                export_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                path = save_export(program, meta, os.path.join(xdir.name,
                                                               name))
                save_s = time.perf_counter() - t0
                del program
                t0 = time.perf_counter()
                serving = ServingModel.load(path, device=dev)
                sync()
                load_s = time.perf_counter() - t0
                nodes = custom_op_nodes(serving.program)
                need = ("gather_rows",) + (("flash_attention",)
                                           if name == "TabTransformer" else ())
                require(all(nodes.get(f"recflow::{k}", 0) > 0 for k in need),
                        f"{name}: the exported graph lacks the kernels' "
                        f"custom ops: {nodes}")
                reset_counts()
                got = [serving.predict(b) for b in served]
                sync()
                counts = read_counts()
                for k in counters:
                    x_launches[k] = x_launches.get(k, 0) + counts[k]
                require(all(counts[k] == nodes[f"recflow::{k}"] * XS["held"]
                            for k in need) or rehearse,
                        f"{name}: the loaded program did not launch its "
                        f"kernels once a node: {counts}, nodes {nodes}")
                require(all(sorted(g) == sorted(k for k in w if k not in
                                                labels)
                            for g, w in zip(got, want)),
                        f"{name}: outputs {sorted(got[0])}")
                err = max(float(np.abs(g[k] - w[k]).max())
                          for g, w in zip(got, want) for k in g)
                require(err <= 1e-6, f"{name}: the loaded program differs "
                        f"from the eager model by {err} > 1e-6")
                require(all(bool(np.isfinite(v).all())
                            for g in got for v in g.values()),
                        f"{name}: non-finite outputs")
                if "score" in got[0]:
                    score = np.concatenate([g["score"] for g in got])
                    require(bool(((score > 0) & (score < 1)).all()),
                            f"{name}: scores outside (0, 1): "
                            f"[{score.min()}, {score.max()}]")
                # the same batch already on the card, the outputs left
                # there: the program's own time beside the eager model's
                dev_in = to_device({k: served[0][k] for k in
                                    serving.batch_keys}, dev)
                dev_batch = to_device({**served[0], **consts}, dev)
                program = serving.program.module()

                def device_ms(fn):
                    with torch.no_grad():
                        fn()
                        sync()
                        t0 = time.perf_counter()
                        for _ in range(XS["reps"]):
                            fn()
                            sync()
                    return (time.perf_counter() - t0) / XS["reps"] * 1e3

                export_serve[name] = {
                    "config": os.path.basename(conf_path), "rows": rows,
                    "custom_op_nodes": nodes,
                    "launches": {k: counts[k] for k in need},
                    "outputs": sorted(got[0]), "max_abs_vs_eager": err,
                    "export_s": export_s, "save_s": save_s, "load_s": load_s,
                    "artifact_mb": os.path.getsize(path) / 2 ** 20,
                    "predict_ms_per_batch": per_batch_ms(serving.predict,
                                                         served),
                    "eager_predict_ms_per_batch": per_batch_ms(eager, served),
                    "program_on_card_ms": device_ms(
                        lambda: program(*dev_in.values())),
                    "eager_on_card_ms": device_ms(lambda: model(dev_batch))}
                if name == "Dcn":
                    dcn_serving, dcn_path, dcn_held = serving, path, served
                    dcn_schema = xschema
                else:
                    os.remove(path)
                del model, serving, want, got, program, dev_in, dev_batch
                if not rehearse:
                    torch.cuda.empty_cache()
            launches["export_serve"] = dict(x_launches)

            # /predict over HTTP with the loaded Dcn
            backend = EncodeServer(serving_model=dcn_serving)
            httpd = make_server(backend, host="127.0.0.1", port=0)
            server = threading.Thread(target=httpd.serve_forever, daemon=True)
            server.start()
            url = f"http://127.0.0.1:{httpd.server_address[1]}"

            def body(batch):
                return json.dumps({"batch": {k: v.tolist() for k, v in
                                             batch.items()}}).encode()

            def post(data):
                req = urllib.request.Request(url + "/predict", data=data,
                                             method="POST")
                with urllib.request.urlopen(req, timeout=300) as r:
                    return json.loads(r.read())

            def bitwise(out, ref):
                return sorted(out) == sorted(ref) and all(
                    np.array_equal(np.asarray(out[k], ref[k].dtype).view(
                        np.uint32), ref[k].view(np.uint32)) for k in ref)

            try:
                with urllib.request.urlopen(url + "/health", timeout=60) as r:
                    health = json.loads(r.read())
                require("/predict" in health["endpoints"] and (
                    rehearse or health["card"] == kind), f"/health {health}")
                refs = [dcn_serving.predict(b) for b in dcn_held]
                bodies = [body(b) for b in dcn_held]
                require(bitwise(post(bodies[0]), refs[0]),
                        "/predict differs from ServingModel.predict")
                failures, same = [], {}

                def client(c):
                    try:
                        i = c % len(bodies)
                        same[c] = bitwise(post(bodies[i]), refs[i])
                    except Exception as e:  # noqa: BLE001 — reported below
                        failures.append(repr(e))

                threads = [threading.Thread(target=client, args=(c,))
                           for c in range(XS["clients"])]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                require(not failures and len(same) == XS["clients"] and
                        all(same.values()), f"concurrent /predict: "
                        f"{failures[:3]} {same}")
                # an id outside its table: 400 from the host check, and the
                # card answers the next request
                slot = dcn_schema.sparse_slots()[0]
                bad = dict(dcn_held[0])
                bad[slot.name] = bad[slot.name].copy()
                bad[slot.name].reshape(-1)[7] = slot.num_rows
                try:
                    post(body(bad))
                    bad_code = 200
                except urllib.error.HTTPError as e:
                    bad_code = e.code
                require(bad_code == 400, f"an id outside its table got "
                        f"{bad_code}, not 400")
                require(bitwise(post(bodies[1 % len(bodies)]),
                                refs[1 % len(refs)]),
                        "/predict after the bad id differs")
                latency = []
                for i in range(XS["latency_reps"]):
                    t0 = time.perf_counter()
                    post(bodies[i % len(bodies)])
                    latency.append((time.perf_counter() - t0) * 1e3)
            finally:
                httpd.shutdown()
                httpd.server_close()
                backend.close()
                server.join(timeout=10)
            # portability: the artifact exported on the card loads on the CPU
            cpu_serving = ServingModel.load(dcn_path, device="cpu")
            cpu_out = cpu_serving.predict(dcn_held[0])
            port_err = float(np.abs(cpu_out["logit"] - refs[0]["logit"]).max())
            require(port_err <= RANK_CPU_TOL, f"the Dcn export on the CPU vs "
                    f"the card: logits differ by {port_err} > {RANK_CPU_TOL}")
            del cpu_serving, dcn_serving
        finally:
            xdir.cleanup()
        log("export_serve", models=export_serve, launches=x_launches,
            tolerance=1e-6, http={
                "health": health, "concurrent_requests": XS["clients"],
                "bitwise": True, "bad_id_code": bad_code,
                "request_mb": len(bodies[0]) / 2 ** 20,
                "predict_ms_median": sorted(latency)[len(latency) // 2],
                "predict_ms": latency},
            cpu_vs_card_logit=port_err, cpu_tolerance=RANK_CPU_TOL, card=card)

    # ------------------------------------------------- 20-21. quantized search
    # benchmarks/bench_quantized_search.py's configuration: 10M x 128 on the
    # card, toy sizes in the rehearsal (still past _HIER_MIN_ITEMS)
    Q = dict(n=10_000_000, q=2048, check_q=256, reps=5, ann_n=1 << 20,
             nlist=4096, nprobe=32) if not rehearse else \
        dict(n=300_000, q=64, check_q=32, reps=1, ann_n=20_000, nlist=64,
             nprobe=8)
    f64 = torch.float64
    qcorpus = flat_ref = None
    if any(p in phases for p in QUANT_PHASES + ("parallel",)):
        t0 = time.perf_counter()
        qcorpus = make_corpus(np, Q["n"], 128)
        corpus_gen_s = time.perf_counter() - t0

    def run_index(index_param, items, queries, **kw):
        """Build through EncoderSearcher (array mode, ip), warm up, then one
        search of every query with the counts reset just before it and read
        just after, and Q["reps"] more for the time."""
        t0 = time.perf_counter()
        es = EncoderSearcher(items=items, index_param=index_param,
                             measurement="ip", device=dev, **kw).train()
        sync()
        build_s = time.perf_counter() - t0
        es.search(queries[:64], topK=K)
        reset_counts()
        sync()
        t0 = time.perf_counter()
        ids, sims = es.search(queries, topK=K)
        sync()
        first_s = time.perf_counter() - t0
        counts = read_counts()
        times = []
        for _ in range(Q["reps"]):
            sync()
            t0 = time.perf_counter()
            es.search(queries, topK=K)
            sync()
            times.append(time.perf_counter() - t0)
        med = sorted(times)[len(times) // 2]
        return es, ids, sims, {"build_s": build_s, "first_search_s": first_s,
                               "search_ms": med * 1e3,
                               "qps": len(queries) / med, "launches": counts}

    def blocks_f64(x_np, rows=1 << 20):
        """(start, rows of an [N, D] numpy array as f64 on the card)."""
        for s0 in range(0, len(x_np), rows):
            yield s0, torch.from_numpy(x_np[s0:s0 + rows]).to(dev).to(f64)

    def exact_scan(q64, blocks):
        """Plain top-K of q·x over row blocks, in f64."""
        best = None
        for s0, xb in blocks:
            best = merge_topk(torch, best, q64 @ xb.T, s0, K)
        return best

    def rows_score(q64, x_of):
        """score_of for check_topk: q·x of the ids, in f64."""
        return lambda ids: torch.einsum("qd,qkd->qk", q64, x_of(ids))

    def check_sq(what, idx, qc, q32, q64, select_k=K):
        """An SQ searcher's top-K of the check queries `qc` against the
        tournament's function in plain f64: the `select_k` best groups of
        bf16(q ⊙ scale)·codes (K on one card; K + 1 for a sharded searcher,
        whose group straddling the corpus's end is pinned first), their
        items rescored by q·x̂ (check_topk, with ties of groups allowed at
        the boundary), and its recall of the exact top-K of q·x̂."""
        cq_ = len(qc)
        codes, n_items = idx._codes, idx.num_items
        sq8 = idx.qtype == "sq8"
        vmin = idx._vmin.to(f64) if sq8 else torch.zeros(128, dtype=f64,
                                                           device=dev)
        scl = idx._scale if sq8 else torch.ones(128, device=dev)
        qb = (q32 * scl).to(torch.bfloat16).to(f64)
        m1, exact = [], None
        for s0 in range(0, codes.shape[0], 1 << 20):
            c = codes[s0:s0 + (1 << 20)].to(f64)
            m = qb @ c.T
            m[:, max(0, n_items - s0):] = -math.inf
            m1.append(m.view(cq_, -1, G).amax(-1))
            x = q64 @ (vmin + scl.to(f64) * c).T
            x[:, max(0, n_items - s0):] = -math.inf
            exact = merge_topk(torch, exact, x, s0, K)
            del c, m, x
        m1 = torch.cat(m1, 1)
        if select_k > K and n_items % G:
            m1[:, n_items // G] = math.inf
        g_top = torch.topk(m1, select_k, dim=1)
        cand = (g_top.indices[:, :, None] * G + torch.arange(G, device=dev)
                ).reshape(cq_, select_k * G)

        def xhat(ids):
            return vmin + scl.to(f64) * codes[ids].to(f64)

        cs = torch.einsum("qd,qkd->qk", q64, xhat(cand))
        cs[cand >= n_items] = -math.inf
        rs, rp = torch.topk(cs, K, dim=1)
        ri = torch.gather(cand, 1, rp)
        kth_group = g_top.values[:, -1]

        def group_near(r, ids):
            gm = m1[r, ids // G]
            return (gm - kth_group[r]).abs() <= \
                SEARCH_RTOL * kth_group[r].abs().clamp(min=1.0)

        ss, si = idx.search(qc, K, return_items=False)
        out = check_topk(torch, what, ss, si, rs, ri, rows_score(q64, xhat),
                         group_near)
        out["recall_vs_exact_xhat"] = recall_at_k(si, exact[1].cpu().numpy())
        return out

    if "sq_search" in phases:
        queries = bench_queries(np, qcorpus, Q["q"])
        cq = Q["check_q"]
        q32 = torch.from_numpy(queries[:cq]).to(dev)
        q64 = q32.to(f64)
        res, checks = {}, {}
        flat, gt, _, res["Flat"] = run_index("Flat", qcorpus, queries)
        require(res["Flat"]["launches"]["grouped_score_max"] ==
                -(-Q["q"] // flat.index.query_block) or rehearse,
                f"Flat launches {res['Flat']['launches']}")
        ref_s, ref_i = exact_scan(q64, blocks_f64(qcorpus))
        flat_ref = (ref_s, ref_i)
        x_dev = flat.index._vecs
        fs, fi = flat.index.search(queries[:cq], K, return_items=False)
        checks["Flat"] = check_topk(
            torch, "Flat", fs, fi, ref_s, ref_i,
            rows_score(q64, lambda ids: x_dev[ids].to(f64)))
        del flat, x_dev
        for spec in ("SQ8", "SQbf16"):
            es, ids, _, res[spec] = run_index(spec, qcorpus, queries)
            idx = es.index
            n_blocks = -(-Q["q"] // idx.query_block)
            form = "grouped_score_max_uint8" if spec == "SQ8" else \
                "grouped_score_max_bf16"
            got = res[spec]["launches"]
            require(rehearse or (got[form] == n_blocks and
                                 got["grouped_score_max"] == n_blocks),
                    f"{spec}: {form} launched {got}, not once per query "
                    f"block ({n_blocks})")
            launches["sq_search" if spec == "SQ8" else "sq_search_bf16"] = got
            checks[spec] = check_sq(spec, idx, queries[:cq], q32, q64)
            res[spec]["recall@100_vs_flat"] = recall_at_k(ids, gt)
            res[spec]["code_gb"] = idx._codes.numel() * \
                idx._codes.element_size() / 1e9
            del es, idx
        sync()
        log("sq_search", n=Q["n"], d=128, queries=Q["q"], k=K,
            checked_queries=cq, corpus_gen_s=corpus_gen_s, tolerance=SEARCH_RTOL,
            results=res, checks=checks,
            peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                         if not rehearse else None))
        if not rehearse:
            torch.cuda.empty_cache()

    if "ann" in phases:
        # the bench run at --n 1,048,576: the generator's first chunk is the
        # first 1,048,576 rows of the 10M corpus; queries drawn from it
        sub = qcorpus[:Q["ann_n"]]
        queries = bench_queries(np, sub, Q["q"])
        cq = Q["check_q"]
        q32 = torch.from_numpy(queries[:cq]).to(dev)
        q64 = q32.to(f64)
        res, checks = {}, {}
        _, gt, _, res["Flat"] = run_index("Flat", sub, queries)
        exact_s, exact_i = exact_scan(q64, blocks_f64(sub))
        sub_dev = torch.from_numpy(sub).to(dev)
        ann = (("IVF%d" % Q["nlist"], {"nprobe": Q["nprobe"]}),
               ("PQ16", {"query_block": 4096}),
               ("IVF%d,PQ16" % Q["nlist"], {"nprobe": Q["nprobe"]}))
        for spec, kw in ann:
            es, ids, _, res[spec] = run_index(spec, sub, queries, **kw)
            res[spec]["recall@100_vs_flat"] = recall_at_k(ids, gt)
            idx = es.index
            if spec.startswith("IVF") and "PQ" not in spec:
                # nprobe = nlist scans every item: the exact search
                idx.nprobe = idx.nlist
                s_, i_ = idx.search(queries[:cq], K, return_items=False)
                idx.nprobe = kw["nprobe"]
                checks[spec + "@full_probe"] = check_topk(
                    torch, spec, s_, i_, exact_s, exact_i,
                    rows_score(q64, lambda ids: sub_dev[ids].to(f64)))
            elif spec == "PQ16":
                # a plain scan of the corpus as the scan decodes it
                cb16 = idx._codebooks.to(torch.bfloat16).to(f64)
                m_ar = torch.arange(cb16.shape[0], device=dev)

                def dec(ids, cb16=cb16, m_ar=m_ar, codes=idx._codes):
                    return cb16[m_ar, codes[ids].long()].flatten(-2)

                ref = None
                for s0 in range(0, len(sub), 1 << 18):
                    ids_b = torch.arange(s0, min(len(sub), s0 + (1 << 18)),
                                         device=dev)
                    ref = merge_topk(torch, ref, q64 @ dec(ids_b).T, s0, K)
                s_, i_ = idx.search(queries[:cq], K, return_items=False)
                checks[spec] = check_topk(torch, spec, s_, i_, *ref,
                                          rows_score(q64, dec))
            else:
                # full probe against the IVF-PQ score in plain f64: the bf16
                # lookup tables of q_s·codebook_s plus q·c for list members,
                # q·x̂ (decoded in f32) for the overflow pool
                msub = idx.num_subspaces
                lut = torch.einsum("qsd,skd->qsk", q32.view(cq, msub, -1),
                                   idx._codebooks).to(torch.bfloat16).to(f64)
                qc = q64 @ idx._centroids.to(f64).T
                assign = torch.from_numpy(idx._assign.astype(np.int64)).to(dev)
                over = torch.zeros(len(sub), dtype=torch.bool, device=dev)
                over[torch.from_numpy(idx._overflow_idx).to(dev)] = True
                over_of = torch.full((len(sub),), -1, dtype=torch.long,
                                     device=dev)
                over_of[torch.from_numpy(idx._overflow_idx).to(dev)] = \
                    torch.arange(len(idx._overflow_idx), device=dev)
                over_s = q64 @ idx._overflow_dec.to(f64).T
                m_ar = torch.arange(msub, device=dev)

                def ivfpq_score(ids, lut=lut, qc=qc, assign=assign,
                                over=over, over_of=over_of, over_s=over_s,
                                codes=idx._codes):
                    rows = torch.arange(cq, device=dev)[:, None]
                    c = codes[ids].long()                  # [cq, n, M]
                    s_ = lut[rows[:, :, None], m_ar, c].sum(-1) + \
                        qc[rows, assign[ids]]
                    if over_s.shape[1] == 0:
                        return s_
                    return torch.where(over[ids], over_s[rows, over_of[ids]
                                                         .clamp(min=0)], s_)

                ref = None
                for s0 in range(0, len(sub), 1 << 16):
                    ids_b = torch.arange(s0, min(len(sub), s0 + (1 << 16)),
                                         device=dev)
                    ref = merge_topk(torch, ref, ivfpq_score(
                        ids_b[None, :].expand(cq, -1)), s0, K)
                idx.nprobe = idx.nlist
                s_, i_ = idx.search(queries[:cq], K, return_items=False)
                idx.nprobe = kw["nprobe"]
                checks[spec + "@full_probe"] = check_topk(
                    torch, spec, s_, i_, *ref, ivfpq_score)
            del es, idx
        sync()
        log("ann", n=len(sub), d=128, queries=Q["q"], k=K, checked_queries=cq,
            nlist=Q["nlist"], nprobe=Q["nprobe"], tolerance=SEARCH_RTOL,
            results=res, checks=checks,
            peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                         if not rehearse else None))
        del sub_dev
    def xhat_of(idx):
        """(x̂ of stored rows in f64 on the card: ids [..] -> [.., D], the
        f64 per-dim scale) of a streamed quantized searcher."""
        sq8 = idx.qtype == "sq8"
        vmin = torch.from_numpy(idx._vmin).to(dev).to(f64) if sq8 else \
            torch.zeros(128, dtype=f64, device=dev)
        scl = torch.from_numpy(idx._scale).to(dev).to(f64) if sq8 else \
            torch.ones(128, dtype=f64, device=dev)
        codes = idx._codes

        def xhat(ids):
            c = codes[ids.reshape(-1).cpu()].to(dev).to(f64)
            return vmin + scl * c.view(*ids.shape, -1)
        return xhat, scl

    def no_worse(what, q64_, xhat, got, ref):
        """Two top-K id lists [Q, K] of one quantized function, `got` from a
        tournament that keeps every group `ref`'s keeps (and more): an id
        only `got` returns scores (over x̂, f64) at least `ref`'s K-th less
        SEARCH_RTOL, an id only `ref` returns at most `got`'s K-th plus it.
        Returns the counts of each."""
        got_only = ref_only = 0
        for r in range(len(got)):
            h, rr = set(got[r].tolist()), set(ref[r].tolist())
            if h == rr:
                continue
            ids = torch.tensor(sorted(h | rr), device=dev)
            sc = dict(zip(ids.tolist(), torch.einsum(
                "d,kd->k", q64_[r], xhat(ids[None, :])[0]).tolist()))
            h_kth, r_kth = min(sc[i] for i in h), min(sc[i] for i in rr)
            tol = SEARCH_RTOL * max(1.0, abs(r_kth))
            for i in h - rr:
                got_only += 1
                require(sc[i] >= r_kth - tol, f"{what}: row {r} id {i} "
                        f"({sc[i]}) below the reference's K-th ({r_kth})")
            for i in rr - h:
                ref_only += 1
                require(sc[i] <= h_kth + tol, f"{what}: row {r} misses id "
                        f"{i} ({sc[i]}) above its K-th ({h_kth})")
        return {"own_only_ids": got_only, "reference_only_ids": ref_only,
                "recall": recall_at_k(got, ref)}

    def host_quantized_check(idx, qs_np, q32, r_ids, what, bn):
        """A streamed quantized searcher's top-K for the queries q32 held two
        ways. (1) Against its own function in plain f64 (check_topk): per
        block of bn rows, the K best groups of bf16(q ⊙ scale)·codes, their
        items rescored by q·x̂, the blocks' winners merged; an id may differ
        only at the boundary (its score, or its group's maximum against its
        block's K-th group, within SEARCH_RTOL). (2) Against the resident
        searcher's top-K r_ids: its per-block tournament keeps every group
        the resident one keeps (and more), so an id only the host returns
        scores (over x̂, f64) at least the resident's K-th less the
        tolerance, and an id only the resident returns at most the host's
        K-th plus it."""
        cq_ = len(qs_np)
        q64_ = q32.to(f64)
        xhat, scl = xhat_of(idx)
        qb = (q32 * scl.float()).to(torch.bfloat16).to(f64)
        codes, n = idx._codes, idx.num_items
        m1s, kth_g, best = [], [], None
        for s0 in range(0, n, bn):
            c = codes[s0:s0 + bn].to(dev).to(f64)
            valid = c.shape[0]
            m = torch.full((cq_, bn), -math.inf, dtype=f64, device=dev)
            m[:, :valid] = qb @ c.T
            m1 = m.view(cq_, bn // G, G).amax(-1)
            g_top = torch.topk(m1, K, dim=1)
            cand = (g_top.indices[:, :, None] * G +
                    torch.arange(G, device=dev)).reshape(cq_, K * G)
            cs = torch.einsum("qd,qkd->qk", q64_,
                              xhat(cand.clamp(max=valid - 1) + s0))
            cs[cand >= valid] = -math.inf
            top, p_ = torch.topk(cs, K, dim=1)
            top_i = torch.gather(cand, 1, p_) + s0
            if best is not None:
                top, p_ = torch.topk(torch.cat([best[0], top], 1), K, dim=1)
                top_i = torch.gather(torch.cat([best[1], top_i], 1), 1, p_)
            best = (top, top_i)
            m1s.append(m1)
            kth_g.append(g_top.values[:, -1])
            del c, m, cs

        def group_near(r, ids):
            near = []
            for i in ids.tolist():
                b, local = divmod(i, bn)
                gm, kth = float(m1s[b][r, local // G]), float(kth_g[b][r])
                near.append(abs(gm - kth) <= SEARCH_RTOL * max(1.0, abs(kth)))
            return torch.tensor(near, device=dev)

        ss, si = idx.search(qs_np, K, return_items=False)
        out = {"vs_function": check_topk(torch, what, ss, si, *best,
                                         rows_score(q64_, xhat), group_near)}
        del m1s, best
        out["vs_resident"] = no_worse(what, q64_, xhat, si, r_ids)
        return out

    # ------------------------------------------------------- 22. host_tier
    if "host_tier" in phases:
        # the same corpus streamed from pinned host memory in blocks of
        # 1,048,576 rows (65,536 in the rehearsal)
        H = dict(block=1 << 20, ivf_q=512) if not rehearse else \
            dict(block=1 << 16, ivf_q=64)
        bn, n_items = H["block"], Q["n"]
        queries = bench_queries(np, qcorpus, Q["q"])
        cq = Q["check_q"]
        q32 = torch.from_numpy(queries[:cq]).to(dev)
        q64 = q32.to(f64)
        if flat_ref is None:
            flat_ref = exact_scan(q64, blocks_f64(qcorpus))
        ref_s, ref_i = flat_ref
        # the resident quantized searchers' codes and top-100s
        resident = {}
        for spec in ("SQ8", "SQbf16"):
            es = EncoderSearcher(items=qcorpus, index_param=spec,
                                 measurement="ip", device=dev).train()
            rs_, ri_ = es.index.search(queries[:cq], K, return_items=False)
            resident[spec] = (es.index._codes[:n_items].cpu(), ri_)
            del es
        if not rehearse:
            torch.cuda.empty_cache()

        def x_rows(ids):
            return torch.from_numpy(qcorpus[ids.cpu().numpy()]).to(dev).to(f64)

        res, checks, stream = {}, {}, {}
        launches["host_tier"] = {}
        timer = Timer(torch, 5) if not rehearse else None
        gt = None
        for spec, form in (("HostFlat", "float32"), ("HostSQbf16", "bfloat16"),
                           ("HostSQ8", "uint8")):
            if not rehearse:
                # earlier phases' reference cycles collected now, not during
                # the search (they would lower its peak below the base)
                gc.collect()
                sync()
                torch.cuda.empty_cache()
                base_mem = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            es, ids, _, res[spec] = run_index(spec, qcorpus, queries,
                                              block_items=bn)
            idx = es.index
            peak = torch.cuda.max_memory_allocated() - base_mem \
                if not rehearse else None
            n_blocks = -(-n_items // bn)
            n_calls = n_blocks * -(-Q["q"] // idx.query_block)
            got = res[spec]["launches"]
            want = {"float32": (n_calls, 0, 0), "bfloat16": (n_calls, 0, n_calls),
                    "uint8": (n_calls, n_calls, 0)}[form]
            have = (got["grouped_score_max"], got["grouped_score_max_uint8"],
                    got["grouped_score_max_bf16"])
            require(rehearse or have == want, f"{spec}: kernel 5 launched "
                    f"{have} (all, uint8, bf16), not {want}")
            for key, v in got.items():
                if isinstance(v, int):
                    launches["host_tier"][key] = \
                        launches["host_tier"].get(key, 0) + v
            codes = idx._codes
            size = codes.element_size()
            if gt is None:
                gt = ids                  # HostFlat: the exact top-100
            res[spec]["recall@100_vs_flat"] = recall_at_k(ids, gt)
            res[spec]["corpus_gb"] = codes.numel() * size / 1e9
            res[spec]["bytes_streamed_per_search"] = \
                codes.numel() * size * -(-Q["q"] // idx.query_block)
            # the memory the streamed search holds on the card: two block
            # buffers, a block's group maxima, the tournament's gathered rows
            # (widened to f32 for a quantized corpus) and 256 MiB for the
            # rest (the tournament's [Q, 1600] ids and scores, the merge)
            qb_ = min(Q["q"], idx.query_block)
            bound = 2 * bn * 128 * size + qb_ * (bn // G) * 4 + \
                qb_ * K * G * 128 * (4 + (size if size < 4 else 0)) + (256 << 20)
            res[spec]["peak_mem_gb"] = None if peak is None else peak / 1e9
            res[spec]["mem_bound_gb"] = bound / 1e9
            require(rehearse or peak < bound, f"{spec}: peak device memory "
                    f"{peak} > the streaming bound {bound}")
            if form == "float32":
                require(rehearse or bound < codes.numel() * size,
                        f"{spec}: the bound {bound} does not show the corpus "
                        f"off the card")
                fs, fi = idx.search(queries[:cq], K, return_items=False)
                checks[spec] = check_topk(torch, spec, fs, fi, ref_s, ref_i,
                                          rows_score(q64, x_rows))
            else:
                if form == "uint8":
                    sq8_host = (idx, ids)     # HostIvf's reference below
                rcodes, r_ids = resident["SQ8" if form == "uint8" else "SQbf16"]
                require(torch.equal(codes, rcodes), f"{spec}: codes differ "
                        f"from the resident searcher's")
                checks[spec] = host_quantized_check(idx, queries[:cq], q32,
                                                    r_ids, spec, bn)
            if not rehearse:
                # the link and the scan apart: a pinned copy of one block,
                # the stream with nothing scanned, one block's scan (kernel
                # 5 and the tournament) and kernel 5 alone, on the card
                buf = torch.empty((bn, 128), dtype=codes.dtype, device=dev)
                buf.copy_(codes[:bn])
                qs_dev = torch.from_numpy(idx._affine(queries)[0]).to(dev)
                copy_ms = timer.median_ms(
                    lambda i: buf.copy_(codes[:bn], non_blocking=True))
                sync()
                t0 = time.perf_counter()
                for _ in idx._stream():
                    pass
                sync()
                copy_only_ms = (time.perf_counter() - t0) * 1e3
                scan_ms = timer.median_ms(
                    lambda i: idx._scan(qs_dev, buf, None, K, bn))
                kern_ms = timer.median_ms(
                    lambda i: k_scan.launch_grouped_score_max(
                        qs_dev, buf, None, group=G, num_items=bn))
                search_ms = res[spec]["search_ms"]
                nbytes = res[spec]["bytes_streamed_per_search"]
                stream[spec] = {
                    "pinned_copy_ms_per_block": copy_ms,
                    "pinned_copy_gb_per_s": bn * 128 * size / copy_ms / 1e6,
                    "streamed_gb_per_s": nbytes / search_ms / 1e6,
                    "copy_only_ms": copy_only_ms,
                    "scan_ms_per_block": scan_ms,
                    "scan_ms": scan_ms * n_blocks,
                    "kernel_ms_per_block": kern_ms,
                    "kernel_busy_share": kern_ms * n_blocks / search_ms,
                    "copy_plus_scan_ms": copy_only_ms + scan_ms * n_blocks,
                    "search_ms": search_ms,
                    "overlap": (copy_only_ms + scan_ms * n_blocks - search_ms)
                    / min(copy_only_ms, scan_ms * n_blocks)}
                del buf, qs_dev
            del es, idx, codes
        # HostIVF4096,SQ8 (the repo's bench) at nprobe 8 and 32, 64 queries
        # a batch: ms and rows shipped a batch, recall@100 against Flat
        ivf_spec = "HostIVF%d,SQ8" % Q["nlist"]
        t0 = time.perf_counter()
        es = EncoderSearcher(items=qcorpus, index_param=ivf_spec,
                             measurement="ip", device=dev, nprobe=8,
                             query_block=64).train()
        sync()
        ivf = {"build_s": time.perf_counter() - t0, "queries": H["ivf_q"]}
        idx = es.index
        qi = queries[:H["ivf_q"]]
        n_b = -(-len(qi) // idx.query_block)
        for nprobe in (8, 32):
            idx.nprobe = nprobe
            idx.search(qi[:idx.query_block], K)
            reset_counts()
            sync()
            t0 = time.perf_counter()
            _, i_ = idx.search(qi, K, return_items=False)
            sync()
            dt = time.perf_counter() - t0
            got = read_counts()
            require(rehearse or got["grouped_score_max_uint8"] == n_b,
                    f"{ivf_spec}: kernel 5 (uint8) launched {got}, not once "
                    f"per 64-query batch ({n_b})")
            rows = [len(idx._union_rows(qi[b:b + idx.query_block]))
                    for b in range(0, len(qi), idx.query_block)]
            ivf[f"nprobe{nprobe}"] = {
                "ms_per_batch": dt / n_b * 1e3, "qps": len(qi) / dt,
                "recall@100_vs_flat": recall_at_k(i_, gt[:len(qi)]),
                "rows_shipped_per_batch": float(np.mean(rows)),
                "bytes_shipped_per_batch": float(np.mean(rows)) * 128,
                "launches": got}
        # every list probed: the union is the whole corpus, scored by one
        # tournament, so its top-100 is HostSQ8's (the same codes and
        # function) but where HostSQ8's per-block tournaments keep more
        # groups; and the probes at 8 and 32 lose under 5% of HostSQ8's
        # recall (a k-means fed corrupted rows loses far more)
        idx.nprobe = idx.nlist
        qf = queries[:idx.query_block]
        _, fi = idx.search(qf, K, return_items=False)
        idx.nprobe = 8
        sq8_idx, sq8_ids = sq8_host
        ivf["HostSQ8_vs_full_probe"] = no_worse(
            ivf_spec, torch.from_numpy(qf).to(dev).to(f64),
            xhat_of(sq8_idx)[0], sq8_ids[:len(qf)], fi)
        floor = 0.95 * res["HostSQ8"]["recall@100_vs_flat"]
        require(all(ivf[f"nprobe{p_}"]["recall@100_vs_flat"] >= floor
                    for p_ in (8, 32)), f"{ivf_spec}: recall@100 below "
                f"{floor}: {ivf}")
        del es, idx, sq8_host, sq8_idx
        log("host_tier", n=n_items, d=128, queries=Q["q"], k=K,
            block_items=bn, checked_queries=cq, tolerance=SEARCH_RTOL,
            results=res, checks=checks, stream=stream, host_ivf=ivf,
            launches=launches["host_tier"])
        del resident

    # -------------------------------------------------------- 23. parallel
    if "parallel" in phases:
        import socket
        import torch.distributed as tdist
        from recommendflow_tpu_torch.parallel import init_distributed, make_mesh
        from recommendflow_tpu_torch.retrieval import index_factory
        from recommendflow_tpu_torch.retrieval.sq import SqSearcher
        from recommendflow_tpu_torch.tools.profile_slice import (_device_stats,
                                                                 count_syncs)
        from recommendflow_tpu_torch.utils.trace import profile_report
        from torch.profiler import ProfilerActivity, profile
        # a world of one over NCCL (gloo in the CPU rehearsal): real process
        # groups and collectives, the sharded code paths at full width
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            pg_port = sk.getsockname()[1]
        init_distributed(0, 1, f"tcp://127.0.0.1:{pg_port}", device=str(dev))
        backend = tdist.get_backend()
        require(backend == ("gloo" if rehearse else "nccl"),
                f"parallel: backend {backend}")
        mesh = make_mesh()
        items_mesh = make_mesh(("items",), current=False)
        pconf = bench_conf if not rehearse else Configuration(DEMO_CONF)
        PT = dict(steps=20, eval_batches=8, prof_steps=10) if not rehearse \
            else dict(steps=2, eval_batches=2, prof_steps=2)
        pschema = compile_schema(pconf.features)
        p_train = [synthetic_batch(pschema, S["batch"], seed=300_000 + i)
                   for i in range(PT["steps"])]
        p_eval = [synthetic_batch(pschema, S["batch"], seed=400_000 + i)
                  for i in range(PT["eval_batches"])]

        def p_trainer(mesh_, shard, mode):
            model_, _ = build_network(pconf.networks["class"], {
                "conf": pconf, "device": dev, "seed": 0})
            return Trainer(model_, table_update=mode, device=dev, seed=0,
                           mesh=mesh_, shard_tables=shard)

        def p_fit(trainer, scan=1, data=p_train):
            """fit over `data` (scan_steps 1: eager; None: the default,
            graphed stacks of 8 on a card) with the evaluation, under
            deterministic algorithms (the duplicate-row sums add in one
            order on both sides): (state, last epoch's logs, ms a step from
            its examples/s)."""
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                res_ = trainer.fit(data, valid_ds=p_eval, scan_steps=scan,
                                   verbose=False)
            finally:
                torch.use_deterministic_algorithms(False)
            logs_ = res_["history"][-1]
            return res_["state"], logs_, \
                S["batch"] / logs_["examples_per_sec"] * 1e3

        def state_of(st):
            """The whole state on the host: weights and buffers, table
            accumulators, the Adam moments by parameter name."""
            out = {f"model/{k}": v.detach().float().cpu()
                   for k, v in st.model.state_dict().items()}
            out.update({f"acc/{k}": v.float().cpu()
                        for k, v in st.table_acc.items()})
            for name, prm in st.model.named_parameters():
                for k, v in st.optimizer.state.get(prm, {}).items():
                    if isinstance(v, torch.Tensor) and v.dim():
                        out[f"opt/{name}/{k}"] = v.float().cpu()
            return out

        def compare(a, b):
            """(bitwise, the largest per-tensor max|a-b| / max|b|, its
            tensor)."""
            require(sorted(a) == sorted(b), "parallel: state keys differ")
            worst, where, bitwise = 0.0, None, True
            for k in a:
                bitwise &= bool(torch.equal(a[k], b[k]))
                den = float(b[k].abs().max()) if b[k].numel() else 0.0
                err = float((a[k] - b[k]).abs().max()) if b[k].numel() else 0.0
                if (err / den if den else err) > worst:
                    worst, where = (err / den if den else err), k
            return bitwise, worst, where

        def profiled(trainer, state_, steps):
            """ms a step (host clock, synchronised), then under
            torch.profiler the device idle share and the host's own time by
            op, and the host's waits a step (CUDA sync debug mode); eager
            steps, after the fit (its first step paid NCCL's set-up)."""
            if rehearse:
                return {"not_measured": "cpu rehearsal"}
            on_dev = [trainer._put(b) for b in p_train[:steps]]
            trainer.train_step(state_, on_dev[0])
            syncs = count_syncs(lambda: trainer.train_step(state_, on_dev[0]))
            sync()
            t0 = time.perf_counter()
            for b in on_dev:
                trainer.train_step(state_, b)
            sync()
            plain_ms = (time.perf_counter() - t0) / steps * 1e3
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof_:
                t0 = time.perf_counter()
                for b in on_dev:
                    trainer.train_step(state_, b)
                sync()
                wall = time.perf_counter() - t0
            st_ = _device_stats(profile_report(prof_), wall, {})
            host = sorted(((a.key[:60], a.self_cpu_time_total / 1e3 / steps,
                            a.count // steps) for a in prof_.key_averages()
                           if a.self_cpu_time_total > 0),
                          key=lambda x: -x[1])[:8]
            return {"ms_per_step": plain_ms,
                    "ms_per_step_profiled": wall / steps * 1e3,
                    "host_self_ms_per_step": [
                        {"name": n, "ms": m, "calls": c} for n, m, c in host],
                    "device_busy_ms_per_step": st_["device_busy_ms"] / steps,
                    "idle_share": st_["idle_share"],
                    "host_waits_per_step": sum(syncs.values()),
                    "host_waits": syncs, "top_ms": st_["top_ms"][:6]}

        # the single-card counterparts first (not counted), then the mesh
        # runs with the counts reset just before and read just after
        # row-sharded tables take the legacy planner's updates: the
        # touched-row one here (kernels 1 and 3 on the block)
        legacy = "sparse"
        single_rep = p_trainer(None, False, "auto")
        single_state, single_logs, single_ms = p_fit(single_rep)
        ref_rep = state_of(single_state)
        single_leg = p_trainer(None, False, legacy)
        leg_state, leg_logs, leg_ms = p_fit(single_leg)
        ref_leg = state_of(leg_state)
        # (the profiled steps below move the states on: compared as above)
        single_times = {"replicated_split": profiled(single_rep, single_state,
                                                     PT["prof_steps"]),
                        f"legacy_{legacy}": profiled(single_leg, leg_state,
                                                     PT["prof_steps"])}
        # fits in the default dispatch (graphed stacks of 8 on a card), as
        # users run them: the single card's, then the mesh's below
        g_data = p_train * (2 if not rehearse else 1)
        g_state, g_logs, graphed_ms = p_fit(p_trainer(None, False, "auto"),
                                            None, g_data)
        ref_graphed = state_of(g_state)
        del g_state
        if not rehearse:
            torch.cuda.empty_cache()

        # the search references: the resident searchers on the same corpus
        p_queries = bench_queries(np, qcorpus, Q["q"])
        cqp = Q["check_q"]
        pq32 = torch.from_numpy(p_queries[:cqp]).to(dev)
        pq64 = pq32.to(f64)
        resident = {}
        for spec in ("Flat", "SQbf16", "SQ8"):
            r_idx = index_factory(128, spec, "ip", device=dev).train(qcorpus)
            r_idx.search(p_queries[:64], K, return_items=False)
            sync()
            ts_ = []
            for _ in range(Q["reps"]):
                t0 = time.perf_counter()
                r_out = r_idx.search(p_queries, K, return_items=False)
                sync()
                ts_.append(time.perf_counter() - t0)
            resident[spec] = {"search_ms": sorted(ts_)[len(ts_) // 2] * 1e3,
                              "top": (r_out[0][:cqp], r_out[1][:cqp])}
            del r_idx
        if not rehearse:
            torch.cuda.empty_cache()
        flat_oracle = flat_ref if flat_ref is not None else \
            exact_scan(pq64, blocks_f64(qcorpus))

        reset_counts()
        mesh_rep = p_trainer(mesh, False, "auto")
        rep_state, rep_logs, rep_ms = p_fit(mesh_rep)
        mesh_shard = p_trainer(mesh, True, legacy)
        shard_state, shard_logs, shard_ms = p_fit(mesh_shard)
        sharded_names = sorted(
            n for n, prm in mesh_shard.model.named_parameters()
            if getattr(prm, "row_shard", None) is not None)
        searchers, search_out = {}, {}
        for spec in ("Flat", "SQbf16", "SQ8"):
            idx = index_factory(128, spec, "ip", mesh=items_mesh)
            searchers[spec] = idx.train(qcorpus)
            search_out[spec] = idx.search(p_queries, K, return_items=False)
        sync()
        launches["parallel"] = read_counts()
        pl = launches["parallel"]
        require(rehearse or (pl["gather_rows"] > 0 and
                             pl["scatter_add_rows"] + pl["sparse_adagrad_apply"]
                             > 0 and pl["grouped_score_max"] > 0 and
                             pl["grouped_score_max_uint8"] > 0 and
                             pl["grouped_score_max_bf16"] > 0),
                f"parallel: a kernel of the path was not launched: {pl}")
        require(sharded_names == ["embedder.table_dim64"] or rehearse,
                f"parallel: row-sharded {sharded_names}")
        # the steps: the mesh against its single-card counterpart
        losses = {"replicated": (rep_logs["loss"], single_logs["loss"]),
                  "sharded": (shard_logs["loss"], leg_logs["loss"])}
        p_checks = {}
        for name, (mesh_st, ref_st, m_logs, r_logs) in {
                "replicated": (rep_state, ref_rep, rep_logs, single_logs),
                "sharded": (shard_state, ref_leg, shard_logs, leg_logs)
        }.items():
            bitwise, worst, where = compare(state_of(mesh_st), ref_st)
            loss_rel = abs(m_logs["loss"] - r_logs["loss"]) / \
                max(abs(r_logs["loss"]), 1e-30)
            evals = {k: (m_logs[k], r_logs[k]) for k in m_logs
                     if k.startswith("val_")}
            eval_rel = max([abs(a - b) / max(abs(b), 1e-30)
                            for a, b in evals.values()] or [0.0])
            require(all(math.isfinite(m_logs[k]) for k in m_logs),
                    f"parallel {name}: {m_logs}")
            require(max(worst, loss_rel, eval_rel) <= PARALLEL_RTOL,
                    f"parallel {name}: the mesh's state / loss / evaluation "
                    f"differ from the single card's by {worst} ({where}) / "
                    f"{loss_rel} / {eval_rel} (relative) > {PARALLEL_RTOL}")
            p_checks[name] = {"state_bitwise": bitwise,
                              "state_max_rel_err": worst,
                              "state_worst_tensor": where,
                              "loss_rel_err": loss_rel, "eval": evals,
                              "eval_max_rel_err": eval_rel}
        # the top-100s: every sharded searcher by the sq_search rules, and
        # against the resident searcher's
        s_checks, s_times = {}, {}
        for spec, idx in searchers.items():
            ss, si = search_out[spec][0][:cqp], search_out[spec][1][:cqp]
            if spec == "Flat":
                x_dev = idx._vecs
                s_checks[spec] = check_topk(
                    torch, f"sharded {spec}", ss, si, *flat_oracle,
                    rows_score(pq64, lambda ids: x_dev[ids].to(f64)))
            else:
                s_checks[spec] = check_sq(f"sharded {spec}", idx,
                                          p_queries[:cqp], pq32, pq64,
                                          select_k=K + 1)
            r_s, r_i = resident[spec]["top"]
            s_checks[spec]["ids_equal_resident"] = float((si == r_i).mean())
            s_checks[spec]["scores_max_rel_vs_resident"] = float(
                (np.abs(ss - r_s) / np.maximum(np.abs(r_s), 1.0)).max())
            ts_ = []
            for _ in range(Q["reps"]):
                t0 = time.perf_counter()
                idx.search(p_queries, K, return_items=False)
                sync()
                ts_.append(time.perf_counter() - t0)
            s_times[spec] = {"search_ms": sorted(ts_)[len(ts_) // 2] * 1e3,
                             "resident_ms": resident[spec]["search_ms"],
                             "n_pad": int((idx._vecs if spec == "Flat"
                                           else idx._codes).shape[0])}
        del searchers, search_out, resident
        # the graphed mesh fits (NCCL collectives captured with the step)
        graph_stats = {}
        for name, shard, mode in (("replicated", False, "auto"),
                                  ("sharded", True, legacy)):
            gt_ = p_trainer(mesh, shard, mode)
            gm_state, gm_logs, gm_ms = p_fit(gt_, None, g_data)
            replays = sum(g["replays"] for g in
                          gt_.graph_stats().get("train", []))
            require(rehearse or replays > 0, f"parallel {name}: the graphed "
                    f"mesh fit replayed no graph {gt_.graph_stats()}")
            require(math.isfinite(gm_logs["loss"]), f"parallel {name}: "
                    f"graphed loss {gm_logs['loss']}")
            graph_stats[name] = {"ms_per_step": gm_ms, "replays": replays,
                                 "loss": gm_logs["loss"]}
            if name == "replicated":
                bitwise, worst, where = compare(state_of(gm_state),
                                                ref_graphed)
                require(worst <= PARALLEL_RTOL, f"parallel: the graphed mesh "
                        f"fit differs from the single card's graphed fit by "
                        f"{worst} ({where})")
                p_checks["replicated_graphed"] = {
                    "state_bitwise": bitwise, "state_max_rel_err": worst,
                    "loss": (gm_logs["loss"], g_logs["loss"])}
            del gt_, gm_state
        if not rehearse:
            torch.cuda.empty_cache()
        mesh_times = {"replicated_split": profiled(mesh_rep, rep_state,
                                                   PT["prof_steps"]),
                      f"sharded_legacy_{legacy}": profiled(
                          mesh_shard, shard_state, PT["prof_steps"])}
        log("parallel", backend=backend, world=tdist.get_world_size(),
            mesh=mesh.shape, config=os.path.basename(
                BENCH_CONF if not rehearse else DEMO_CONF),
            batch=S["batch"], steps=PT["steps"], legacy_update=legacy,
            row_sharded=sharded_names, tolerance=PARALLEL_RTOL,
            steps_check=p_checks, fit_ms_per_step={
                "single_eager": single_ms, "single_legacy_eager": leg_ms,
                "single_graphed": graphed_ms, "mesh_replicated": rep_ms,
                "mesh_sharded": shard_ms,
                "mesh_replicated_graphed": graph_stats["replicated"][
                    "ms_per_step"],
                "mesh_sharded_graphed": graph_stats["sharded"]["ms_per_step"]},
            graphed=graph_stats,
            single_card=single_times, mesh_steps=mesh_times,
            search={"n": Q["n"], "queries": Q["q"], "k": K,
                    "checked_queries": cqp, "checks": s_checks,
                    "times": s_times}, launches=pl, card=card)
        del (single_rep, single_leg, mesh_rep, mesh_shard, single_state,
             leg_state, rep_state, shard_state, ref_rep, ref_leg, ref_graphed)
        tdist.destroy_process_group()
        if not rehearse:
            torch.cuda.empty_cache()

    del qcorpus
    if not rehearse:
        torch.cuda.empty_cache()

    # -------------------------------------------------------- 24. cascade
    if "cascade" in phases:
        import importlib.util
        from recommendflow_tpu_torch.data.pipeline import Dataset, resolve_paths
        spec = importlib.util.spec_from_file_location(
            "cascade_demo_torch",
            os.path.join(ROOT, "examples", "cascade_demo_torch.py"))
        demo = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(demo)
        CS = dict(conf=BENCH_CONF, batch=1024, train_rows=32 * 1024,
                  eval_batches=1024, min_items=_kernels._HIER_MIN_ITEMS,
                  check_q=256) if not rehearse else \
            dict(conf=DEMO_CONF, batch=64, train_rows=16 * 64,
                 eval_batches=16, min_items=0, check_q=32)
        cconf = Configuration(CS["conf"])
        cschema = compile_schema(cconf.features)
        ctmp = tempfile.mkdtemp(prefix="cascade_")
        t0 = time.perf_counter()
        generate_records(cconf, ctmp, num_rows=CS["train_rows"], num_files=2,
                         seed=31)
        records_s = time.perf_counter() - t0
        train_ds = Dataset(cschema, resolve_paths(ctmp),
                           batch_size=CS["batch"], shuffle=True, seed=0)

        class Rows:
            """The evaluation rows: synthetic batches from fixed seeds,
            made anew on each pass (both predicts see the same rows)."""

            def __init__(self, n):
                self.n = n

            def __len__(self):
                return self.n

            def __iter__(self):
                for i in range(self.n):
                    yield synthetic_batch(cschema, CS["batch"],
                                          seed=700_000 + i)

        ad_slots = [sl.name for sl in cschema.tower_slots("ad")]

        def distinct_positive_items(n):
            """The distinct item-feature rows among the positives of the
            first n batches: the corpus the de-duplication will keep."""
            keys = []
            for b in Rows(n):
                pos = b["label"] > 0.5
                keys.append(np.concatenate(
                    [b[k][pos].reshape(int(pos.sum()), -1).astype(np.float64)
                     for k in ad_slots], axis=1))
            return len(np.unique(np.concatenate(keys), axis=0))

        # more rows are served while the positives' distinct items fall
        # short of the tournament's threshold (2% of margin)
        n_eval = CS["eval_batches"]
        host_items = distinct_positive_items(n_eval)
        while host_items < CS["min_items"] * 1.02:
            n_eval += 256
            host_items = distinct_positive_items(n_eval)
        stage_counts = {}

        def on_stage(name):
            sync()
            stage_counts[name] = read_counts()
            reset_counts()

        if not rehearse:
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        sync()
        res = demo.run_cascade(cconf, train_ds, Rows(n_eval), dev,
                               recall_kw={}, rank_kw={}, recall_epochs=1,
                               rank_epochs=1, on_stage=on_stage)
        total = {}
        for counts in stage_counts.values():
            for kk, v in counts.items():
                if isinstance(v, dict):
                    merged = total.setdefault(kk, {})
                    for w, c in v.items():
                        merged[w] = merged.get(w, 0) + c
                else:
                    total[kk] = total.get(kk, 0) + v
        launches["cascade"] = total
        searcher, k = res["searcher"], res["k"]
        n_items = searcher.num_items
        require(n_items >= CS["min_items"], f"cascade: a corpus of {n_items} "
                f"items, below the tournament's {CS['min_items']}")
        fits = {kk: stage_counts["recall_fit"][kk] + stage_counts["rank_fit"][kk]
                for kk in ("gather_rows", "scatter_add_rows",
                           "sparse_adagrad_apply", "rowwise_adagrad_update")}
        require(rehearse or all(v > 0 for v in fits.values()),
                f"cascade: a table kernel was not launched in the fits: {fits}")
        require(rehearse or all(stage_counts[st]["gather_rows"] > 0 for st in (
            "recall_fit", "rank_fit", "recall_predict", "rank_predict")),
                f"cascade: gather_rows not launched in a stage: {stage_counts}")
        srch = stage_counts["search"]
        require(rehearse or (srch["grouped_score_max"] > 0 and
                             srch["grouped_score_max_uint8"] == 0 and
                             srch["grouped_score_max_bf16"] == 0),
                f"cascade: the search did not run kernel 5's f32 form: {srch}")
        losses = [h["loss"] for h in res["recall_history"] + res["rank_history"]]
        require(all(math.isfinite(x) for x in losses), f"cascade: losses "
                f"{losses}")
        # stage-1 top-50s of a sample of queries against a plain f64 scan of
        # the searcher's own (normalised) corpus
        pick = np.random.default_rng(3).choice(len(res["queries"]),
                                               CS["check_q"], replace=False)
        qs = torch.from_numpy(res["queries"][pick]).to(dev).double()
        qs = qs / qs.norm(dim=1, keepdim=True)
        exact = qs @ searcher._vecs[:n_items].double().T
        ref_s, ref_i = torch.topk(exact, k, dim=1)
        topk_check = check_topk(
            torch, "cascade top-50", res["cand_scores"][pick],
            res["cand_items"][pick], ref_s, ref_i,
            lambda ids: torch.gather(exact, 1, ids))
        del exact, qs
        s1, s2 = res["stage1"], res["stage2"]
        require(s2[f"hit@{k}"] == s1[f"hit@{k}"], f"cascade: re-ranked "
                f"hit@{k} {s2[f'hit@{k}']} != stage-1's {s1[f'hit@{k}']}")
        require(all(0.0 <= m[f"hit@{k}"] <= 1.0 for m in (s1, s2)),
                f"cascade: hit@{k} {s1} {s2}")
        require(bool((np.sort(res["reordered"], axis=1) ==
                      np.sort(res["cand_items"], axis=1)).all()),
                "cascade: the re-order changed a candidate set")
        secs = res["seconds"]
        n_q = len(res["queries"])
        steps = {"recall": res["recall_steps"], "rank": res["rank_steps"]}
        log("cascade", config=os.path.basename(CS["conf"]), batch=CS["batch"],
            train_rows=CS["train_rows"], records_s=records_s, steps=steps,
            eval_rows=n_eval * CS["batch"], positives=n_q,
            host_distinct_items=host_items, corpus_items=n_items,
            n_pad=int(searcher._vecs.shape[0]), k=k, seconds=secs,
            ms={"recall_fit_per_step": secs["recall_fit"] / steps["recall"]
                * 1e3,
                "recall_predict_per_batch": secs["recall_predict"] / n_eval
                * 1e3,
                "search_per_4096_queries": secs["search"] / n_q * 4096 * 1e3,
                "rank_fit_per_step": secs["rank_fit"] / steps["rank"] * 1e3,
                "rank_predict_per_batch": secs["rank_predict"] / n_eval
                * 1e3},
            stage1=s1, stage2=s2, losses=losses, topk_check=topk_check,
            launches=launches["cascade"], launches_by_stage=stage_counts,
            peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                         if not rehearse else None))
        del res, searcher, train_ds
        shutil.rmtree(ctmp, ignore_errors=True)
        gc.collect()
        if not rehearse:
            torch.cuda.empty_cache()

    # --------------------------------------------------------- 25. encode
    if "encode" in phases:
        t0 = time.perf_counter()
        service = encoder_service()
        load_s = time.perf_counter() - t0
        service.warmup()
        if not rehearse:
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        sync()
        t0 = time.perf_counter()
        emb = service.encode(texts)
        sync()
        encode_s = time.perf_counter() - t0
        launches["encode"] = read_counts()
        n_batches = -(-len(texts) // E["batch"])
        require(launches["encode"]["flash_attention"] == layers * n_batches
                or rehearse, f"flash_attention launched "
                f"{launches['encode']['flash_attention']} times on the encode "
                f"path, not {layers} x {n_batches} batches")
        require(emb.shape == (len(texts), cfg["hidden_size"]),
                f"encode shape {emb.shape}")
        require(bool(np.isfinite(emb).all()), "non-finite text vectors")
        norm_err = float(np.abs(np.linalg.norm(emb, axis=1) - 1.0).max())
        require(norm_err <= 1e-4, f"text vectors not unit ({norm_err})")
        again = service.encode(texts[:1000])
        cache_equal = bool(np.array_equal(again, emb[:1000]))
        require(cache_equal, "the cache returned other rows")
        # the model's vectors on the card against the CPU's plain path
        few = texts[:8]
        cpu_svc = TextEncoderService.from_pretrained(
            *bert_files, max_len=64, batch_size=len(few), device="cpu")
        cpu_err = float(np.abs(service._encode_raw(few)
                               - cpu_svc._encode_raw(few)).max())
        del cpu_svc
        require(cpu_err <= ENCODE_CPU_TOL, f"encode on the card vs the CPU: "
                f"{cpu_err} > {ENCODE_CPU_TOL}")
        tok_counts = (tokenizer.encode_batch(texts, 64)[0] > 0).sum(1)
        log("encode", config={k: cfg[k] for k in (
                "vocab_size", "hidden_size", "num_hidden_layers",
                "num_attention_heads", "intermediate_size")},
            texts=len(texts), batch=E["batch"], batches=n_batches,
            tokens={"min": int(tok_counts.min()),
                    "median": float(np.median(tok_counts)),
                    "max": int(tok_counts.max()),
                    "truncated_share": float((tok_counts == 64).mean())},
            load_s=load_s, encode_s=encode_s,
            ms_per_batch_with_fit=encode_s / n_batches * 1e3,
            launches=launches["encode"], unit_norm_err=norm_err,
            cache_equal=cache_equal, cpu_vs_card=cpu_err,
            cpu_tolerance=ENCODE_CPU_TOL,
            peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                         if not rehearse else None))
        del again

    # ---------------------------------------------------------- 26. serve
    serve_latency = None
    if "serve" in phases:
        import threading
        import urllib.request
        from recommendflow_tpu_torch.serving import (EncodeServer,
                                                     RemoteEncoderClient,
                                                     make_server)
        service = encoder_service()
        backend = EncodeServer(service, max_batch=4096, batch_window_ms=4.0)
        httpd = make_server(backend, host="127.0.0.1", port=0)
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            client = RemoteEncoderClient(url, local=None, request_timeout=120)
            require(client.ping(), "/health did not answer ok")
            with urllib.request.urlopen(url + "/health", timeout=60) as r:
                health = json.loads(r.read())
            require(health["device"] == str(dev) and (
                rehearse or health["card"] == kind), f"/health {health}")
            fresh = [t for t in enc_syn.make_texts(
                E["serve_clients"] * 2 * E["serve_texts"]
                + 2 * E["latency_reps"], seed=2) if t not in service._cache]
            n_conc = E["serve_clients"] * 2 * E["serve_texts"]
            conc, single = fresh[:n_conc], fresh[n_conc:]
            results, failures = {}, []

            def serve_client(c):
                for r in range(2):
                    at = (c * 2 + r) * E["serve_texts"]
                    try:
                        results[at] = client.encode(
                            conc[at:at + E["serve_texts"]])
                    except Exception as e:  # noqa: BLE001 — reported below
                        failures.append(repr(e))

            batches_before = backend._batcher.batches_run
            reset_counts()
            threads = [threading.Thread(target=serve_client, args=(c,))
                       for c in range(E["serve_clients"])]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            conc_s = time.perf_counter() - t0
            require(not failures, f"/encode requests failed: {failures[:3]}")
            conc_batches = backend._batcher.batches_run - batches_before
            lat_one, lat_batch = [], []
            for i in range(E["latency_reps"]):
                t0 = time.perf_counter()
                results[n_conc + i] = client.encode([single[i]])
                lat_one.append((time.perf_counter() - t0) * 1e3)
            block = single[E["latency_reps"]:]
            t0 = time.perf_counter()
            results[n_conc + E["latency_reps"]] = client.encode(block)
            lat_batch.append((time.perf_counter() - t0) * 1e3)
            serve_launches = read_counts()["flash_attention"]
            require(serve_launches > 0 or rehearse,
                    "the served texts were not encoded on the card")
            served = np.concatenate([results[k] for k in sorted(results)])
            direct = service.encode(conc + single)
            serve_err = float(np.abs(served - direct).max())
            require(served.dtype == np.float32 and
                    bool(np.array_equal(served, direct)),
                    f"served vectors differ from a direct encode: {serve_err}")
            serve_latency = {"one_text_ms_median": sorted(lat_one)[len(lat_one) // 2],
                             "one_text_ms": lat_one,
                             f"{len(block)}_texts_ms": lat_batch[0]}
            with urllib.request.urlopen(url + "/health", timeout=60) as r:
                health = json.loads(r.read())
        finally:
            httpd.shutdown()
            httpd.server_close()
            backend.close()
            server.join(timeout=10)
        log("serve", health=health, concurrent_requests=2 * E["serve_clients"],
            texts_per_request=E["serve_texts"], concurrent_s=conc_s,
            concurrent_encode_calls=conc_batches,
            flash_attention_launches=serve_launches,
            served_vs_direct=serve_err, latency=serve_latency)

    # ------------------------------------------------------ 27. text_search
    if "text_search" in phases:
        service = encoder_service()
        if emb is None:
            emb = service.encode(texts)
        t0 = time.perf_counter()
        es = EncoderSearcher(items=emb, index_param="SQ8", measurement="cos",
                             device=dev).train()
        sync()
        build_s = time.perf_counter() - t0
        qv = service.encode(texts)           # the service's own encode
        reset_counts()
        sync()
        t0 = time.perf_counter()
        ids, sims = es.search(qv, topK=10)
        sync()
        search_s = time.perf_counter() - t0
        hit = (ids == np.arange(len(texts))[:, None]).any(1)
        require(bool(hit.all()), f"text_search: {int((~hit).sum())} texts "
                f"missing from their own top-10")
        log("text_search", items=len(emb), dim=int(emb.shape[1]),
            index="SQ8", metric="cos", build_s=build_s, search_s=search_s,
            self_in_top10=float(hit.mean()),
            self_at_rank0=float((ids[:, 0] == np.arange(len(texts))).mean()),
            tournament=es.index._codes.shape[0] >= _kernels._HIER_MIN_ITEMS,
            launches=read_counts())
        del es

    # ------------------------------------------------------------ 28. cli
    if "cli" in phases:
        from recommendflow_tpu_torch.cli import evaluate as eval_cli
        from recommendflow_tpu_torch.cli import predict as pred_cli
        from recommendflow_tpu_torch.cli import train as train_cli
        from recommendflow_tpu_torch.train.checkpoint import read_checkpoint
        demo = Configuration(DEMO_CONF)
        with tempfile.TemporaryDirectory() as tmp:
            generate_records(demo, os.path.join(tmp, "rec"),
                             num_rows=S["cli_rows"], num_files=2)
            data = os.path.join(tmp, "rec", "*.rfb")
            metrics = eval_cli.main([DEMO_CONF, "--data", data, "--device",
                                     str(dev), "--topk", "5,10,50"])
            require(bool(metrics) and all(math.isfinite(v)
                                          for v in metrics.values()),
                    f"evaluate CLI metrics {metrics}")
            # weights through the interop file: predict must equal the model
            model, _ = build_network(demo.networks["class"],
                                     {"conf": demo, "device": dev, "seed": 7})
            ckpt = save_variables_npz(os.path.join(tmp, "vars.npz"),
                                      jax_from_variables(model.state_dict()))
            outs = pred_cli.main([DEMO_CONF, "--data", data, "--checkpoint",
                                  ckpt, "--out", os.path.join(tmp, "p.npz"),
                                  "--device", str(dev)])
            from recommendflow_tpu_torch.data.pipeline import make_dataset
            ds, _ = make_dataset(demo, data, 2048, shuffle=False,
                                 drop_remainder=False)
            direct = predict(model, ds, dev)
            n = S["cli_rows"]
            require(outs["user"].shape == (n, 128), f"{outs['user'].shape}")
            diff = max(float(np.abs(outs[k] - direct[k]).max())
                       for k in ("user", "ad"))
            require(diff <= 1e-5, f"predict CLI vs direct model: {diff}")
            # train, then predict from the checkpoint it saved
            res = train_cli.main([DEMO_CONF, "--data", data, "--train_mode",
                                  "test", "--device", str(dev),
                                  "--batch_size", str(min(256, n // 8)),
                                  "--model_save_root", os.path.join(tmp, "m")])
            final = os.path.join(tmp, "m", "ckpt", "final.pt")
            hist = res["history"][-1]
            require(math.isfinite(hist["loss"]), f"train CLI logs {hist}")
            outs2 = pred_cli.main([DEMO_CONF, "--data", data, "--checkpoint",
                                   final, "--out", os.path.join(tmp, "p2.npz"),
                                   "--device", str(dev)])
            model.load_state_dict(read_checkpoint(final)["model"])
            direct2 = predict(model, ds, dev)
            diff2 = max(float(np.abs(outs2[k] - direct2[k]).max())
                        for k in ("user", "ad"))
            require(diff2 <= 1e-5, f"predict CLI on the trained checkpoint vs "
                    f"the model: {diff2}")
            del model
            # a ranking model (demo_ranking's Dnn): cli/train monitoring
            # val_auc, then cli/evaluate and cli/predict on its checkpoint
            rdemo = Configuration(DEMO_RANK_CONF)
            generate_records(rdemo, os.path.join(tmp, "rrec"),
                             num_rows=S["cli_rows"], num_files=2)
            rdata = os.path.join(tmp, "rrec", "*.rfb")
            rres = train_cli.main([
                DEMO_RANK_CONF, "--data", rdata, "--train_mode", "test",
                "--device", str(dev), "--batch_size", str(min(256, n // 8)),
                "--monitor", "val_auc", "--model_save_root",
                os.path.join(tmp, "rm")])
            rhist = rres["history"][-1]
            require(math.isfinite(rhist["loss"]) and
                    0.0 <= rhist.get("val_auc", -1.0) <= 1.0,
                    f"ranking train CLI logs {rhist}")
            rfinal = os.path.join(tmp, "rm", "ckpt", "final.pt")
            rmetrics = eval_cli.main([DEMO_RANK_CONF, "--data", rdata,
                                      "--checkpoint", rfinal, "--device",
                                      str(dev)])
            require(0.0 <= rmetrics["auc"] <= 1.0,
                    f"ranking evaluate CLI {rmetrics}")
            routs = pred_cli.main([DEMO_RANK_CONF, "--data", rdata,
                                   "--checkpoint", rfinal, "--out",
                                   os.path.join(tmp, "rp.npz"), "--device",
                                   str(dev)])
            rds, _ = make_dataset(rdemo, rdata, 2048, shuffle=False,
                                  drop_remainder=False)
            rdirect = predict(rres["state"].model, rds, dev)
            rdiff = float(np.abs(routs["score"] - rdirect["score"]).max())
            require(routs["score"].shape == (n,) and rdiff <= 1e-5,
                    f"ranking predict CLI vs the trained model: {rdiff}")
            del rres
            # cli/export on that checkpoint, cli/serve --model, and /predict
            # on the first rows against cli/predict's scores for them
            import threading
            import urllib.request
            from recommendflow_tpu_torch.cli import export as export_cli
            from recommendflow_tpu_torch.cli import serve as serve_cli
            xb = min(256, n // 8)
            xpath = export_cli.main([DEMO_RANK_CONF, "--checkpoint", rfinal,
                                     "--out", os.path.join(tmp, "rx"),
                                     "--batch_size", str(xb), "--device",
                                     str(dev)])
            backend, httpd = serve_cli.build([
                "--model", xpath, "--host", "127.0.0.1", "--port", "0",
                "--device", str(dev)])
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            xds, _ = make_dataset(rdemo, rdata, xb, shuffle=False,
                                  valid_ratio=0.0, drop_remainder=False)
            rows = next(iter(xds))
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{httpd.server_address[1]}/predict",
                    data=json.dumps({"batch": {k: np.asarray(v).tolist()
                                               for k, v in rows.items()}}
                                    ).encode(), method="POST")
                with urllib.request.urlopen(req, timeout=300) as r:
                    xserved = np.asarray(json.loads(r.read())["score"],
                                         np.float32)
            finally:
                httpd.shutdown()
                httpd.server_close()
                backend.close()
            xdiff = float(np.abs(xserved - routs["score"][:xb]).max())
            require(xserved.shape == (xb,) and xdiff <= 1e-5,
                    f"cli/serve --model /predict vs cli/predict: {xdiff}")
            # Din (conf/demo_din.yaml) the same way
            ddemo = Configuration(DEMO_DIN_CONF)
            generate_records(ddemo, os.path.join(tmp, "drec"),
                             num_rows=S["cli_rows"], num_files=2)
            ddata = os.path.join(tmp, "drec", "*.rfb")
            dres = train_cli.main([
                DEMO_DIN_CONF, "--data", ddata, "--train_mode", "test",
                "--device", str(dev), "--batch_size", str(min(256, n // 8)),
                "--monitor", "val_auc", "--model_save_root",
                os.path.join(tmp, "dm")])
            dhist = dres["history"][-1]
            require(math.isfinite(dhist["loss"]) and
                    0.0 <= dhist.get("val_auc", -1.0) <= 1.0,
                    f"Din train CLI logs {dhist}")
            dfinal = os.path.join(tmp, "dm", "ckpt", "final.pt")
            dmetrics = eval_cli.main([DEMO_DIN_CONF, "--data", ddata,
                                      "--checkpoint", dfinal, "--device",
                                      str(dev)])
            require(0.0 <= dmetrics["auc"] <= 1.0,
                    f"Din evaluate CLI {dmetrics}")
            douts = pred_cli.main([DEMO_DIN_CONF, "--data", ddata,
                                   "--checkpoint", dfinal, "--out",
                                   os.path.join(tmp, "dp.npz"), "--device",
                                   str(dev)])
            dds, _ = make_dataset(ddemo, ddata, 2048, shuffle=False,
                                  drop_remainder=False)
            ddirect = predict(dres["state"].model, dds, dev)
            ddiff = float(np.abs(douts["score"] - ddirect["score"]).max())
            require(douts["score"].shape == (n,) and ddiff <= 1e-5,
                    f"Din predict CLI vs the trained model: {ddiff}")
            del dres
            # SiameseEncoder (conf/demo_text_recall.yaml) the same way: the
            # recall evaluation from cli/train and cli/evaluate
            tdemo = Configuration(text_conf)
            generate_records(tdemo, os.path.join(tmp, "trec"),
                             num_rows=S["cli_rows"], num_files=2)
            tdata = os.path.join(tmp, "trec", "*.rfb")
            tres = train_cli.main([
                text_conf, "--data", tdata, "--train_mode", "test",
                "--device", str(dev), "--batch_size", str(min(256, n // 8)),
                "--topk", "5,10", "--model_save_root",
                os.path.join(tmp, "tm")])
            thist = tres["history"][-1]
            trecall = {k: v for k, v in thist.items()
                       if k.startswith("val_hit@")}
            require(math.isfinite(thist["loss"]) and bool(trecall) and
                    all(0.0 <= v <= 1.0 for v in trecall.values()),
                    f"SiameseEncoder train CLI logs {thist}")
            tfinal = os.path.join(tmp, "tm", "ckpt", "final.pt")
            tmetrics = eval_cli.main([text_conf, "--data", tdata,
                                      "--checkpoint", tfinal, "--device",
                                      str(dev), "--topk", "5,10"])
            require(bool(tmetrics) and all(math.isfinite(v)
                                           for v in tmetrics.values()),
                    f"SiameseEncoder evaluate CLI {tmetrics}")
            touts = pred_cli.main([text_conf, "--data", tdata, "--checkpoint",
                                   tfinal, "--out", os.path.join(tmp, "tp.npz"),
                                   "--device", str(dev)])
            tds_, _ = make_dataset(tdemo, tdata, 2048, shuffle=False,
                                   drop_remainder=False)
            tdirect = predict(tres["state"].model, tds_, dev)
            tdiff = max(float(np.abs(touts[k] - tdirect[k]).max())
                        for k in ("user", "ad"))
            require(touts["user"].shape == (n, 64) and tdiff <= 1e-5,
                    f"SiameseEncoder predict CLI vs the trained model: {tdiff}")
            del tres
            # cli/encode at its own widths, weights saved by the service
            from recommendflow_tpu_torch.cli import encode as encode_cli
            vocab_path = os.path.join(tmp, "vocab.txt")
            with open(vocab_path, "w") as f:
                f.write("\n".join(vocab) + "\n")
            widths = ["--model_dim", "256", "--num_layers", "4"]
            enc_svc = TextEncoderService(Tokenizer(vocab_path), max_len=64,
                                         use_whitening=True, model_dim=256,
                                         num_layers=4, device=dev, seed=1)
            cli_texts = texts[:E["cli_texts"]]
            enc_ref = enc_svc.encode(cli_texts)
            enc_svc.save(os.path.join(tmp, "encoder"))
            with open(os.path.join(tmp, "texts.txt"), "w") as f:
                f.write("\n".join(cli_texts) + "\n")
            enc_out = encode_cli.main([
                "--vocab", vocab_path, "--input", os.path.join(tmp, "texts.txt"),
                "--out", os.path.join(tmp, "emb.npz"), "--weights",
                os.path.join(tmp, "encoder"), "--whitening", "--device",
                str(dev), *widths])
            require(enc_out.shape == (len(cli_texts), 256) and
                    bool(np.isfinite(enc_out).all()),
                    f"encode CLI output {enc_out.shape}")
            enc_diff = float(np.abs(enc_out - enc_ref).max())
            require(enc_diff <= CLI_TOL, f"encode CLI vs its service: "
                    f"{enc_diff}")
            del enc_svc
        log("cli", rows=n, evaluate_metrics=metrics, predict_vs_model=diff,
            train_cli={k: v for k, v in hist.items()
                       if k in ("loss", "examples_per_sec", "val_hit@5")},
            trained_predict_vs_model=diff2,
            ranking_cli={"train": {k: v for k, v in rhist.items() if k in (
                "loss", "examples_per_sec", "val_auc")},
                "evaluate": rmetrics, "predict_vs_model": rdiff,
                "export_serve_predict_vs_predict_cli": xdiff,
                "export_batch": xb},
            din_cli={"train": {k: v for k, v in dhist.items() if k in (
                "loss", "examples_per_sec", "val_auc")},
                "evaluate": dmetrics, "predict_vs_model": ddiff},
            text_cli={"train": {k: v for k, v in thist.items() if k in (
                "loss", "examples_per_sec") or k.startswith("val_hit@")},
                "evaluate": tmetrics, "predict_vs_model": tdiff},
            encode_cli_texts=len(cli_texts), encode_cli_vs_service=enc_diff)

    own_signals()

    # ---------------------------------------------------------- 29. times
    kernels = []
    if "times" in phases and not rehearse:
        timer = Timer(torch, S["reps"])
        row = {}

        def add(name, ms, plain_ms, library_ms, bytes_, ops=0.0, peak=None,
                **extra):
            t_bytes, t_ops = bytes_ / bw, ops / (peak or flops)
            kernels.append(dict(
                name=name, **KERNEL_META[name],
                launches=launches[KERNEL_PATH[name]].get(name, 0),
                launches_by_path={p: c.get(name, 0) for p, c in launches.items()},
                max_abs_err=errs.get(name), ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="operations" if t_ops > t_bytes else "bytes",
                library_ms=library_ms, **extra))
            row[name] = {"bytes": bytes_, "ops": ops}

        def table_kernel_times(stored_, upd_, acc_, gd_):
            """Kernels 2-4 at one table's shape, on one batch's update (each
            timed call updates its table in place, as the trainer's does).
            {name: (ms, plain ms, library ms or None, bytes)}."""
            u, sm, nv = upd_["uid"], upd_["summed"], upd_["n_valid"]
            n_u = int(nv)
            n_t = int(upd_["touched"].sum())
            R_, W = stored_.shape
            uv, smv = u[:n_u].long(), sm[:n_u]
            out = {}
            out["scatter_add_rows"] = (
                timer.median_ms(lambda i: k_rows.scatter_add_rows(u, sm, gd_,
                                                                  nv)),
                timer.median_ms(lambda i: k_rows.scatter_add_rows_plain(
                    u, sm, gd_, nv)),
                timer.median_ms(lambda i: gd_.index_add_(0, uv,
                                                         smv.to(gd_.dtype))),
                n_u * (4 + W * 4 + 2 * W * 2) + 4)
            p_t, a_t = stored_.clone(), acc_.clone()
            out["rowwise_adagrad_update"] = (
                timer.median_ms(lambda i: k_dense.rowwise_adagrad_update(
                    p_t, a_t, gd_, lr=LR)),
                timer.median_ms(lambda i: k_dense.rowwise_adagrad_update_plain(
                    p_t, a_t, gd_, lr=LR)),
                None,
                # g and acc read whole; p read and written, acc written,
                # only where the gradient is not zero (the touched rows)
                R_ * W * 2 + R_ * 4 + n_t * (2 * W * 2 + 4))
            out["sparse_adagrad_apply"] = (
                timer.median_ms(lambda i: k_sparse.sparse_adagrad_apply(
                    p_t, a_t, u, sm, nv, lr=LR)),
                timer.median_ms(lambda i: k_sparse.sparse_adagrad_apply_plain(
                    p_t, a_t, u, sm, nv, lr=LR)),
                None,
                n_u * (4 + W * 4 + 2 * W * 2 + 2 * 4) + 4)
            return out, {"table": [R_, W], "unique_stored_rows": n_u,
                         "touched_stored_rows": n_t}

        # kernel 1 at every phase-2 shape, one batch's ids a timed call: the
        # median of single calls between two events (as every kernel here)
        # and the mean of reps calls between two events; its launches at
        # that row width on the path that runs the shape
        table32 = ranking_table()
        shape_path = {"recall_serving": "slice", "recall_split": "train",
                      "ranking_serving": "ranking",
                      "ranking_serving_zipf1.2": "ranking",
                      "ranking_split": "ranking"}
        gather_times = {}
        for name, (table_, ids_) in gather_cases(table32, 20_000,
                                                 S["reps"]).items():
            row_b = table_.shape[1] * table_.element_size()
            n_ids, uniq = ids_[0].numel(), torch.unique(ids_[0]).numel()
            nbytes = uniq * row_b + n_ids * row_b + n_ids * 4
            call = (lambda i, t=table_, x=ids_: k_rows.launch_gather_rows(
                t, x[i], check_ids=False))
            ms = timer.median_ms(call)
            batched = timer.batched_ms(call)
            bound = nbytes / bw * 1e3
            gather_times[name] = {
                "table": list(table_.shape), "row_bytes": row_b,
                "ids": n_ids, "unique_rows": uniq, "bytes": nbytes,
                "ms": ms, "batched_ms": batched, "bound_ms": bound,
                "bound_by": "bytes", "share_of_bound": bound / ms,
                "share_of_bound_batched": bound / batched,
                "plain_ms": timer.median_ms(
                    lambda i, t=table_, x=ids_: k_rows.gather_rows_plain(
                        t, x[i])),
                "library_ms": timer.median_ms(
                    lambda i, t=table_, x=ids_: torch.index_select(
                        t, 0, x[i])),
                "launches": launches[shape_path[name]].get(
                    "gather_rows_by_row_bytes", {}).get(row_b, 0)}
        rs = gather_times["recall_serving"]
        add("gather_rows", rs["ms"], rs["plain_ms"], rs["library_ms"],
            rs["bytes"], shapes=gather_times)
        # the grouped duplicate sum at Dssm's two tables (phase 6b): one
        # graph replay each way; bytes: ids and bf16 gradients read, the f32
        # sums (padding included), uid and valid written
        if "dssm_recall" in comb_times:
            cr = comb_times["dssm_recall"]
            cw = COMBINE_LAYOUTS["dssm_recall"][0][1]
            add("combine_row_grads", cr["grouped_replay_ms"],
                cr["per_table_pytorch_replay_ms"], None,
                cr["ids"] * (4 + cw * 2 + cw * 4 + 4 + 1),
                shapes=comb_times)
        # kernels 2-4 at the bench_recall shape (phases 4-6): the kernels
        # line
        recall_times, recall_shape = table_kernel_times(stored, upd, acc0, gd)
        for name in ("scatter_add_rows", "rowwise_adagrad_update",
                     "sparse_adagrad_apply"):
            add(name, *recall_times[name])
        # and at the bench_ranking shape
        stored32 = table32.view(-1, 256)
        upd32 = update_inputs(10_003, **rank)
        gd32 = torch.zeros_like(stored32)
        k_rows.scatter_add_rows(upd32["uid"], upd32["summed"], gd32,
                                upd32["n_valid"])
        acc32 = torch.rand((stored32.shape[0], 1), generator=gen,
                           device=dev) + 0.1
        rank_times, rank_shape = table_kernel_times(stored32, upd32, acc32,
                                                    gd32)
        ranking_shape = {"shape": rank_shape, **{
            name: {"ms": ms, "plain_ms": plain, "library_ms": lib,
                   "bound_ms": nbytes / bw * 1e3, "bound_by": "bytes",
                   "bytes": nbytes}
            for name, (ms, plain, lib, nbytes) in rank_times.items()}}
        del table32, stored32, upd32, gd32, acc32

        nq, n_pad, d = S["q"], S["n_pad"], S["d"]
        add("grouped_score_max",
            timer.median_ms(lambda i: k_scan.launch_grouped_score_max(
                q, corpus, None, group=G, num_items=num_items)),
            timer.median_ms(lambda i: k_scan.grouped_score_max_plain(
                q, corpus, None, group=G, num_items=num_items), SCAN_REPS),
            timer.median_ms(lambda i: torch.matmul(q, corpus.T).view(
                nq, n_pad // G, G).amax(dim=-1), SCAN_REPS),
            4 * (nq * d + n_pad * d + nq * (n_pad // G)),
            ops=2.0 * nq * num_items * d)
        # the uint8 form on phase 3's SQ8 codes; its products are bf16 x
        # bf16 (queries rounded to bf16, codes <= 255), so its bound is the
        # bf16 tensor-core rate. The library call multiplies the rounded
        # queries with the widened codes, then takes the group max.
        qs_b, codes_f = qs_u.to(torch.bfloat16).float(), codes_u.float()
        add("grouped_score_max_uint8",
            timer.median_ms(lambda i: k_scan.launch_grouped_score_max(
                qs_u, codes_u, None, group=G, num_items=num_items)),
            timer.median_ms(lambda i: k_scan.grouped_score_max_plain(
                qs_u, codes_u, None, group=G, num_items=num_items), SCAN_REPS),
            timer.median_ms(lambda i: torch.matmul(qs_b, codes_f.T).view(
                nq, n_pad // G, G).amax(dim=-1), SCAN_REPS),
            n_pad * d + 4 * (nq * d + nq * (n_pad // G)),
            ops=2.0 * nq * num_items * d, peak=bf16_tc)
        del qs_b, codes_f
        # kernel 5's bf16 form does the same bf16 x bf16 work on the bf16
        # corpus; the library call multiplies the rounded queries with the
        # widened corpus, then takes the group max
        corpus_b = corpus.to(torch.bfloat16)
        q_b, corpus_bf = q.to(torch.bfloat16).float(), corpus_b.float()
        add("grouped_score_max_bf16",
            timer.median_ms(lambda i: k_scan.launch_grouped_score_max(
                q, corpus_b, None, group=G, num_items=num_items)),
            timer.median_ms(lambda i: k_scan.grouped_score_max_plain(
                q, corpus_b, None, group=G, num_items=num_items), SCAN_REPS),
            timer.median_ms(lambda i: torch.matmul(q_b, corpus_bf.T).view(
                nq, n_pad // G, G).amax(dim=-1), SCAN_REPS),
            2 * n_pad * d + 4 * (nq * d + nq * (n_pad // G)),
            ops=2.0 * nq * num_items * d, peak=bf16_tc)
        del corpus_b, q_b, corpus_bf

        # flash_attention at TabTransformer's bench_ranking shape, f32, no
        # mask: the forward beside its bound and SDPA; the backward alone
        # (reads q, k, v and dO, writes dq, dk, dv; recomputes the scores,
        # then four more products) and forward + backward through the
        # autograd Function, the plain version and SDPA
        tq, tk, tv = tab_qkv(torch.float32)
        tgo = torch.randn(tq.shape, generator=gen, device=dev)
        tb_, th_, tl_, td_ = (TAB[k] for k in "bhld")
        t_numel = tq.numel()

        def roofline(nbytes, ops):
            t_b, t_o = nbytes / bw, ops / flops
            return {"bound_ms": max(t_b, t_o) * 1e3,
                    "bound_by": "operations" if t_o > t_b else "bytes",
                    "bytes": nbytes, "ops": ops}

        def fa_roofline(b, h, l, d, mask, backward=False):
            """Kernel 6's dense bound (every row of K and V read) beside its
            valid-key bound (only the rows the key mask keeps, and the
            products with them: what this input needs). The forward reads q
            and writes o whole; the backward reads q and dO and writes dq,
            dk and dv whole (dk and dv are 0 at a masked key)."""
            full = 4 * b * h * l * d
            share = float(mask.float().mean()) if mask is not None else 1.0
            m_bytes = mask.numel() if mask is not None else 0
            n_full = 5 if backward else 2
            flops = (10.0 if backward else 4.0) * b * h * l * l * d
            return {**roofline((n_full + 2) * full + m_bytes, flops),
                    "valid_key_share": share,
                    "valid_keys": roofline(
                        n_full * full + 2 * full * share + m_bytes,
                        flops * share)}

        def fwd_bwd(fn, q_, k_, v_, go_):
            def call(i):
                leaves = [t.detach().requires_grad_() for t in (q_, k_, v_)]
                torch.autograd.grad(fn(*leaves), leaves, go_)
            return call

        tab_fa = {
            "shape": [tb_, th_, tl_, td_], "mask": None,
            "ms": timer.median_ms(lambda i: k_fa.launch_flash_attention(
                tq, tk, tv)),
            "plain_ms": timer.median_ms(lambda i: k_fa.flash_attention_plain(
                tq, tk, tv)),
            "library_ms": timer.median_ms(
                lambda i: torch.nn.functional.scaled_dot_product_attention(
                    tq, tk, tv)),
            "launches": launches["attention_ranking"].get("flash_attention", 0),
            **roofline(4 * 4 * t_numel, 4.0 * tb_ * th_ * tl_ * tl_ * td_)}
        tab_bwd = {
            "shape": [tb_, th_, tl_, td_],
            "ms": timer.median_ms(lambda i: k_fa.flash_attention_backward(
                tq, tk, tv, None, tgo)),
            "fwd_bwd_ms": timer.median_ms(fwd_bwd(
                k_fa.flash_attention, tq, tk, tv, tgo)),
            "plain_fwd_bwd_ms": timer.median_ms(fwd_bwd(
                k_fa.flash_attention_plain, tq, tk, tv, tgo)),
            "library_fwd_bwd_ms": timer.median_ms(fwd_bwd(
                torch.nn.functional.scaled_dot_product_attention,
                tq, tk, tv, tgo)),
            **roofline(7 * 4 * t_numel, 10.0 * tb_ * th_ * tl_ * tl_ * td_)}
        del tq, tk, tv, tgo
        # and at text_recall's shape: BERT-Base over a batch of 128 texts of
        # 64 tokens with that batch's trailing-pad key masks (the first 128
        # of the encode texts' masks when text_recall did not run)
        xmask = tr_mask if tr_mask is not None else fa_mask[:128]
        xq, xk, xv = [split_heads(torch.randn(
            (xmask.shape[0], TEXT_LEN, heads * head_dim), generator=gen,
            device=dev), heads) for _ in range(3)]
        xgo = torch.randn(xq.shape, generator=gen, device=dev)
        xb, xh, xl, xd = xq.shape

        def masked(fn):
            return lambda q_, k_, v_: fn(q_, k_, v_, xmask)

        def sdpa_masked(q_, k_, v_):
            return torch.nn.functional.scaled_dot_product_attention(
                q_, k_, v_, attn_mask=xmask[:, None, None, :])

        text_fa = {
            "shape": [xb, xh, xl, xd], "mask": "trailing pads",
            "ms": timer.median_ms(lambda i: k_fa.launch_flash_attention(
                xq, xk, xv, xmask)),
            "plain_ms": timer.median_ms(lambda i: k_fa.flash_attention_plain(
                xq, xk, xv, xmask)),
            "library_ms": timer.median_ms(lambda i: sdpa_masked(xq, xk, xv)),
            "launches": launches["text_recall"].get("flash_attention", 0),
            # held against the plain version on the path's own layer inputs
            # (text_recall phase)
            "check": tr_fa, **fa_roofline(xb, xh, xl, xd, xmask)}
        text_bwd = {
            "shape": [xb, xh, xl, xd],
            "ms": timer.median_ms(lambda i: k_fa.flash_attention_backward(
                xq, xk, xv, xmask, xgo)),
            "fwd_bwd_ms": timer.median_ms(fwd_bwd(
                masked(k_fa.flash_attention), xq, xk, xv, xgo)),
            "plain_fwd_bwd_ms": timer.median_ms(fwd_bwd(
                masked(k_fa.flash_attention_plain), xq, xk, xv, xgo)),
            "library_fwd_bwd_ms": timer.median_ms(fwd_bwd(
                sdpa_masked, xq, xk, xv, xgo)),
            **fa_roofline(xb, xh, xl, xd, xmask, backward=True)}
        del xq, xk, xv, xgo
        # flash_attention at the encoder's shape, f32, a batch's key mask;
        # its bound counts the keys the mask keeps
        qp, kp, vp = path_qkv(torch.float32)
        nb, nl = E["batch"], 64
        enc_fa = fa_roofline(nb, heads, nl, head_dim, fa_mask)
        add("flash_attention",
            timer.median_ms(lambda i: k_fa.launch_flash_attention(
                qp, kp, vp, fa_mask)),
            timer.median_ms(lambda i: k_fa.flash_attention_plain(
                qp, kp, vp, fa_mask)),
            timer.median_ms(lambda i: torch.nn.functional
                            .scaled_dot_product_attention(
                                qp, kp, vp, attn_mask=fa_mask[:, None, None, :])),
            enc_fa["valid_keys"]["bytes"], ops=enc_fa["valid_keys"]["ops"],
            dense_bound_ms=enc_fa["bound_ms"],
            valid_key_share=enc_fa["valid_key_share"],
            shapes={"tabtransformer": tab_fa,
                    "tabtransformer_backward": tab_bwd,
                    "text_recall": text_fa, "text_recall_backward": text_bwd})
        del qp, kp, vp
        # the encode path: steady wall time, then a profiled window
        from recommendflow_tpu_torch.tools.profile_slice import profile_encode
        service = encoder_service()
        chunk = texts[:16 * E["batch"]]
        service._encode_raw(chunk[:E["batch"]])
        sync()
        t0 = time.perf_counter()
        service._encode_raw(chunk)
        sync()
        enc_wall = time.perf_counter() - t0
        enc_prof = profile_encode(service, texts, batches=8)
        encode_times = {
            "ms_per_batch": enc_wall / 16 * 1e3,
            "texts_per_s": len(chunk) / enc_wall,
            "profiled": {k: enc_prof[k] for k in (
                "per_batch_wall_ms", "per_batch_device_ms", "idle_share",
                "texts_per_s", "top_ms", "port_kernels")}}
        zero_ms = timer.median_ms(lambda i: gd.zero_())
        # the timing's own floor: two events with nothing between them, and
        # a kernel that does nothing (a zero-cycle spin), timed as above
        floor = {"events_ms": timer.median_ms(lambda i: None),
                 "empty_kernel_ms": timer.median_ms(
                     lambda i: torch.cuda._sleep(0)),
                 "empty_kernel_batched_ms": timer.batched_ms(
                     lambda i: torch.cuda._sleep(0))}
        log("times", card=card, peaks={"bytes_per_s": bw, "fp32_flops": flops,
                                       "bf16_tensor_core_flops": bf16_tc},
            shapes={"gather_rows": gather_times,
                    "grouped_score_max": {"q": nq, "n_pad": n_pad, "d": d},
                    "grouped_score_max_uint8": {"q": nq, "n_pad": n_pad,
                                                "d": d, "codes": "uint8"},
                    "grouped_score_max_bf16": {"q": nq, "n_pad": n_pad,
                                               "d": d, "corpus": "bfloat16"},
                    "flash_attention": [E["batch"], heads, 64, head_dim],
                    "flash_attention_tabtransformer": [tb_, th_, tl_, td_],
                    "flash_attention_text_recall": [xb, xh, xl, xd],
                    "update_ids": upd["n_ids"],
                    **{k: recall_shape[k] for k in (
                        "table", "unique_stored_rows", "touched_stored_rows")}},
            work=row, ranking_shape=ranking_shape, zero_fill_ms=zero_ms,
            timing_floor=floor,
            zero_fill_bound_ms=stored.numel() * 2 / bw * 1e3,
            library_ms_note={"rowwise_adagrad_update": "no single PyTorch call",
                             "sparse_adagrad_apply": "no single PyTorch call",
                             "flash_attention": "scaled_dot_product_attention "
                             "with the boolean key mask"},
            encode=encode_times, serve_latency=serve_latency,
            reps=S["reps"])

    svc = None
    enc_tmp.cleanup()
    if rehearse:
        print("chip_smoke: CPU rehearsal done (no result without a card)")
        return 3
    if phases != list(PHASES):
        print(f"chip_smoke: partial run {phases} (no result)")
        return 4
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
