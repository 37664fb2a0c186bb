"""Run-time services: stage scheduling, checkpoint/resume, retries."""
