#!/bin/bash
# End-to-end Clair3 retraining pipeline (reference:
# scripts/realign_pipeline.sh — its hardcoded cluster paths become
# arguments/env vars, the nPoRe CLIs become the npore_tpu equivalents, and
# the bgzip/tabix/bcftools-GT-filter subprocesses run in-process through
# npore_tpu's own BGZF writer and filter CLI).
#
# Structure mirrors the reference exactly:
#   * stage toggles           (reference :3-16   -> env flags below)
#   * train/test chromosomes  (reference :18-21)
#   * iteration loop          (reference :428-456): per iteration
#       rephase -> std_ref -> realign -> cand_call, then a terminal
#       rephase -> std_ref -> realign -> var_call
#   * std_ref      (reference :156-210): itr 0 unphases the truth VCF;
#       itr>0 rephases the previous standard against the current reads,
#       then standardizes with npore_tpu.cli.standardize_vcf
#   * cand_call    (reference :214-296): optional pileup-model retrain
#       (tensor generation + training), Clair3 pileup calling
#       (--haplotypes after itr 0), GT=0/0 exclusion, overlap filter
#   * rephase      (reference :300-331): whatshap phase + haplotag
#   * realign      (reference :335-362): npore_tpu realignment
#   * var_call     (reference :366-423): optional full-model retrain,
#       full-model calling, GT=0/0 exclusion
#
# External tools (minimap2, samtools, whatshap, clair3) must be on PATH;
# they are deployment dependencies, not bundled. bgzip/tabix/bcftools are
# NOT required — npore_tpu does those steps in-process.
#
# usage: ./realign_pipeline.sh <workdir> <reads.fastq> <ref.fasta> \
#            <truth.vcf.gz> <truth.bed> <stats_dir>
set -euo pipefail

wd=${1:?workdir}
fastq=${2:?reads.fastq}
ref=${3:?ref.fasta}
ref_vcf=${4:?truth.vcf.gz}
ref_bed=${5:?truth.bed}
stats=${6:?stats_dir}
here=$(cd "$(dirname "$0")" && pwd)
mkdir -p "$wd"

# stage toggles (reference :3-16)
align_reads=${STAGE_ALIGN:-0}
cand_call_reads=${STAGE_CAND_CALL:-0}
train_clair3=${STAGE_TRAIN_CLAIR3:-0}
rephase_reads=${STAGE_REPHASE:-0}
standard_ref=${STAGE_STD_REF:-0}
realign_reads=${STAGE_REALIGN:-1}
var_call_reads=${STAGE_VAR_CALL:-0}
start_itr=${START_ITR:-1}
stop_itr=${STOP_ITR:-1}

# regions of interest (reference :18-21)
train_chrs=${TRAIN_CHRS:-"chr1,chr2,chr3,chr4,chr5,chr6,chr7,chr8,chr9,chr10,chr11,chr12,chr13,chr14,chr15,chr16,chr17,chr18,chr19"}
test_chrs=${TEST_CHRS:-"chr20,chr21,chr22"}
all_chrs="$train_chrs,$test_chrs"

# clair3 deployment (reference :40, :221-226)
clair3_dir=${CLAIR3_DIR:-}
clair3_model=${CLAIR3_MODEL:-}

# region beds (reference :66-77)
bed="$wd/region.bed"; rm -f "$bed"
test_bed="$wd/test_region.bed"; rm -f "$test_bed"
for chr in ${all_chrs//,/ }; do grep -w "$chr" "$ref_bed" >> "$bed" || true; done
for chr in ${test_chrs//,/ }; do grep -w "$chr" "$ref_bed" >> "$test_bed" || true; done

stage() { echo; echo "== $* =="; }

align() {                                 # reference :138-152
    stage "aligning reads"
    mkdir -p "$wd/bam"
    "$here/align.sh" "$fastq" "$ref" "$wd/bam/all"
    ln -sf "$wd/bam/all.bam" "$wd/0_reads.bam"
    ln -sf "$wd/bam/all.bam.bai" "$wd/0_reads.bam.bai"
}

std_ref() {                               # reference :156-210
    local itr=$1
    stage "creating standard reference (itr $itr)"
    mkdir -p "$wd/ref"
    if [ "$itr" = 0 ]; then
        if [ -f "$wd/ref/0_std.vcf.gz" ]; then
            echo "    [std ref: exists, skipping]"
        else
            whatshap unphase "$ref_vcf" > "$wd/ref/0_std.vcf"
            # in-process bgzip+tabix (reference shells out, :170-176)
            python3 -c "
from npore_tpu.io.vcf import VcfReader, write_vcf
v = VcfReader('$wd/ref/0_std.vcf')
write_vcf('$wd/ref/0_std.vcf.gz', v.header_lines, iter(v))"
        fi
        return
    fi
    # rephase the previous standard against the current reads (:181-194)
    whatshap phase \
        "$wd/ref/$((itr-1))_std.vcf.gz" \
        "$wd/${itr}_phased.bam" \
        --output "$wd/ref/${itr}_phased.vcf.gz" \
        --reference "$ref" --ignore-read-groups --indels
    tabix -f -p vcf "$wd/ref/${itr}_phased.vcf.gz" 2>/dev/null || true
    # standardize with the device engine (:202-209)
    python3 -m npore_tpu.cli.standardize_vcf \
        --vcf "$wd/ref/${itr}_phased.vcf.gz" \
        --ref "$ref" \
        --out_prefix "$wd/ref/${itr}_std" \
        --contigs "$all_chrs" \
        --stats_dir "$stats"
}

cand_call() {                             # reference :214-296
    local itr=$1
    if [ "$train_clair3" = 1 ]; then
        stage "retraining candidate caller (itr $itr)"
        "$clair3_dir/generate_pileup_tensors.sh" \
            "$wd/ref/${itr}_std.vcf.gz" "$wd/${itr}_reads.bam" \
            "$ref" "$ref_bed" "$train_chrs" "$wd/${itr}_clair3" "$itr"
        "$clair3_dir/train_pileup_model.sh" "$wd/${itr}_clair3" "$itr"
        model="$wd/${itr}_clair3/train_pileup"
    else
        model="${clair3_model:?set CLAIR3_MODEL or STAGE_TRAIN_CLAIR3=1}"
    fi

    stage "calling candidates (itr $itr)"
    hap_flag=""
    [ "$itr" != 0 ] && hap_flag="--haplotypes"    # reference :245-258
    "$clair3_dir/run_clair3.sh" \
        --bam_fn="$wd/${itr}_reads.bam" --ref_fn="$ref" --bed_fn="$bed" \
        --threads="$(nproc)" --platform=ont --pileup_only $hap_flag \
        --model_path="$model" --output="$wd/tmp"
    mv "$wd/tmp/pileup.vcf.gz" "$wd/$((itr+1))_candidates.vcf.gz"
    mv "$wd/tmp/pileup.vcf.gz.tbi" "$wd/$((itr+1))_candidates.vcf.gz.tbi" \
        2>/dev/null || true
    rm -rf "$wd/tmp"

    stage "filtering candidates (itr $itr)"
    # GT=0/0 exclusion + overlap filter, both in-process (:277-293)
    python3 -m npore_tpu.cli.filter \
        "$wd/$((itr+1))_candidates.vcf.gz" \
        "$wd/$((itr+1))_allcalls.vcf.gz" --exclude_gt 0/0
    python3 -m npore_tpu.cli.filter \
        "$wd/$((itr+1))_allcalls.vcf.gz" \
        "$wd/$((itr+1))_calls.vcf.gz"
}

rephase() {                               # reference :300-331
    local itr=$1
    stage "rephasing calls (itr $itr)"
    whatshap phase \
        "$wd/${itr}_calls.vcf.gz" "$wd/$((itr-1))_reads.bam" \
        --output "$wd/${itr}_phased.vcf.gz" \
        --reference "$ref" --ignore-read-groups --indels
    tabix -f -p vcf "$wd/${itr}_phased.vcf.gz" 2>/dev/null || true
    stage "rephasing reads (itr $itr)"
    whatshap haplotag \
        --output "$wd/${itr}_phased.bam" \
        --reference "$ref" --ignore-read-groups \
        "$wd/${itr}_phased.vcf.gz" "$wd/$((itr-1))_reads.bam"
    samtools index "$wd/${itr}_phased.bam"
    python3 "$here/tag_unphased.py" "$wd/${itr}_phased.bam" \
        "$wd/${itr}_phased_all.sam"
}

realign() {                               # reference :335-362
    local itr=$1
    stage "realigning reads (itr $itr)"
    python3 -m npore_tpu.cli.realign \
        --bam "$wd/${itr}_phased.bam" --ref "$ref" \
        --out_prefix "$wd/${itr}_reads" \
        --contigs "$all_chrs" \
        --stats_dir "$stats"
    "$here/align.sh" "$wd/${itr}_reads.sam" "$ref" "$wd/${itr}_reads"
}

var_call() {                              # reference :366-423
    local itr=$1
    if [ "$train_clair3" = 1 ]; then
        stage "retraining variant caller (itr $itr)"
        "$clair3_dir/generate_full_tensors.sh" \
            "$wd/ref/${itr}_std.vcf.gz" "$wd/$((itr+1))_reads.bam" \
            "$ref" "$ref_bed" "$train_chrs" "$wd/${itr}_clair3_full" "$itr"
        "$clair3_dir/train_full_model.sh" "$wd/${itr}_clair3_full" "$itr"
    fi
    stage "calling variants (itr $itr)"
    "$clair3_dir/run_full_model.sh" "$wd" "$itr" "$ref" "$test_chrs"
    mv "$wd/merge_output.vcf.gz" "$wd/$((itr+1))_variant_cands.vcf.gz"
    mv "$wd/merge_output.vcf.gz.tbi" \
        "$wd/$((itr+1))_variant_cands.vcf.gz.tbi" 2>/dev/null || true
    stage "filtering variants (itr $itr)"
    python3 -m npore_tpu.cli.filter \
        "$wd/$((itr+1))_variant_cands.vcf.gz" \
        "$wd/$((itr+1))_variants.vcf.gz" --exclude_gt 0/0
}

main() {                                  # reference :428-456
    [ "$align_reads" = 1 ] && align
    itr=$start_itr
    for itr in $(seq "$start_itr" "$stop_itr"); do
        stage "### ITERATION $itr ###"
        if [ "$itr" = 0 ]; then
            [ "$standard_ref" = 1 ] && std_ref 0
        else
            [ "$rephase_reads" = 1 ] && rephase "$itr"
            [ "$standard_ref" = 1 ] && std_ref "$itr"
            [ "$realign_reads" = 1 ] && realign "$itr"
        fi
        [ "$cand_call_reads" = 1 ] && cand_call "$itr"
    done
    if [ "$var_call_reads" = 1 ]; then
        [ "$rephase_reads" = 1 ] && rephase $((itr+1))
        [ "$standard_ref" = 1 ] && [ "$train_clair3" = 1 ] && \
            std_ref $((itr+1))
        [ "$realign_reads" = 1 ] && realign $((itr+1))
        var_call "$stop_itr"
    fi
    true
}
main
